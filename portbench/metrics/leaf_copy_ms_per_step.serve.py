"""Backend leaf: copying a step's inputs to the card, where a copy from
pageable memory may wait for the device: the workers' ``leaf_copy`` spans
that start in the window, summed, over the workers' ``device`` spans that
start in it, in ms.  Moves ``tpot_p50_ms``."""
from portbench.metrics import _leaf


def read(data, job):
    return _leaf.ms_per_device_span(data, "leaf_copy")
