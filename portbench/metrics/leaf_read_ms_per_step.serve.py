"""Backend leaf: the blocking read of the sampled tokens back to the
host, which waits for the card to finish the step: the workers'
``leaf_read`` spans that start in the window, summed, over the workers'
``device`` spans that start in it, in ms.  Moves ``tpot_p50_ms``."""
from portbench.metrics import _leaf


def read(data, job):
    return _leaf.ms_per_device_span(data, "leaf_read")
