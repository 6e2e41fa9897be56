"""EngineCore scheduler (``Scheduler.schedule``): the engine's
``scheduler`` spans in the window, over the plans it published in the
window, in ms.  Moves ``tpot_p50_ms``."""
from portbench.metrics import _spans


def read(data, job):
    return _spans.per_step(data, ("scheduler",))
