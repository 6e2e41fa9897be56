"""Backend leaf (``TorchBackend.execute``: B1, the captured k-step loop,
the output projection): the mean of the workers' ``device`` spans in the
window, the host wall of ``execute`` ending in the host read of the
sampled tokens, in ms.  Moves ``tpot_p50_ms``."""
from portbench.metrics import _spans


def read(data, job):
    return _spans.mean_ms(data, "device", "worker")
