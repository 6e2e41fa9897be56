"""Worker dispatch (``core.engine._worker``): the mean of the workers'
``dispatch`` spans in the window (one a plan in each worker), in ms.
Moves ``tpot_p50_ms``."""
from portbench.metrics import _spans


def read(data, job):
    return _spans.mean_ms(data, "dispatch", "worker")
