"""Whole request: the median over every request due in the window of the
time from its scheduled send to its first token, in ms, a request never
answered a miss (``drivers/serve.end_to_end``).  A per-layer metric: on
the card's shared host it spreads 12-21% (first to third quartile over
the median) between runs of one code, and one seed's runs differ as
much as two seeds' do (``PERF.md`` §2): more than the largest bound
allows.  It moves ``tpot_p50_ms``: a request's prefill shares the
engine's steps, and its tokenizing the host's cores, with every request
that decodes."""
from portbench.drivers import serve


def read(data, job):
    return serve.end_to_end(data)["ttft_p50_ms"]
