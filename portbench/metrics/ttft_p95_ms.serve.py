"""Whole request: the 95th percentile over every request due in the window
of the time from its scheduled send to its first token, in ms, a request
never answered a miss (``drivers/serve.end_to_end``).  A per-layer
metric: on the card's shared host its spread between runs (18-70% in two
sets of six) is too wide to bound, as is that of the median
(``ttft_p50_ms.serve``).  Moves ``tpot_p50_ms``, as the median does."""
from portbench.drivers import serve


def read(data, job):
    return serve.end_to_end(data)["ttft_p95_ms"]
