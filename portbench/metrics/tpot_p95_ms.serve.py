"""Whole request: the 95th percentile over every request due in the window
of its time per output token after the first, in ms, a miss as for
``ttft_p95_ms.serve`` (``drivers/serve.end_to_end``).  A per-layer metric
for the same reason; it moves with the bounded median ``tpot_p50_ms``."""
from portbench.drivers import serve


def read(data, job):
    return serve.end_to_end(data)["tpot_p95_ms"]
