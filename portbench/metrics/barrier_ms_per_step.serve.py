"""Completion barrier (``CompletionBoard.wait_all``): the mean of the
engine's ``barrier`` spans in the window, in ms.  Moves
``tpot_p50_ms``."""
from portbench.metrics import _spans


def read(data, job):
    return _spans.mean_ms(data, "barrier", "engine")
