"""Plan broadcast (``core.shm_broadcast``): the engine's ``shm_encode``
and ``shm_publish`` spans in the window, over the plans published in it,
in ms.  Moves ``tpot_p50_ms``."""
from portbench.metrics import _spans


def read(data, job):
    return _spans.per_step(data, ("shm_encode", "shm_publish"))
