"""Backend leaf: enqueueing a step's device work (projections, scatters,
B1, ``flat @ wo``, argmax, or the k-step loop's graph replays), host time
and not device time: the workers' ``leaf_launch`` spans that start in the
window, summed, over the workers' ``device`` spans that start in it, in
ms.  Moves ``tpot_p50_ms``."""
from portbench.metrics import _leaf


def read(data, job):
    return _leaf.ms_per_device_span(data, "leaf_launch")
