"""Backend leaf: building a step's host-side inputs (the token, page and
slot lists of a K/V write, the host arrays of a sampling step and of the
k-step loop): the workers' ``leaf_pack`` spans that start in the window,
summed, over the workers' ``device`` spans that start in it, in ms.
Moves ``tpot_p50_ms``."""
from portbench.metrics import _leaf


def read(data, job):
    return _leaf.ms_per_device_span(data, "leaf_pack")
