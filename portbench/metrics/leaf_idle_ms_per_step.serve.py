"""Backend leaf: the leaf's host work that the card does not cover.  The
seconds of the window in which no device operation of either worker runs
(the workers' ``torch.profiler`` traces) and at least one worker is inside
its ``device`` span but in neither its ``leaf_copy`` nor its ``leaf_read``
spans, where the host waits on the card; over the plans the engine
published in the window, in ms.  Moves ``tpot_p50_ms``."""
from portbench.metrics import _leaf


def read(data, job):
    return _leaf.idle_ms_per_step(data)
