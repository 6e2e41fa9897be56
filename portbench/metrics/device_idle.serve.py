"""The card, in a serving cell: the share of the window in which no kernel
ran, in %: the window not covered by the union of both workers' device
operations' intervals, from each worker's ``torch.profiler`` trace
(``drivers/recorder.py``).  Moves ``tpot_p50_ms``."""
from portbench import stats


def read(data, job):
    tr = data.get("device_trace")
    if not tr or not tr["ops"]:
        return None
    busy = stats.covered([(s, s + d) for _, s, d in tr["ops"]],
                         tr["t0"], tr["t1"])
    return 100.0 * (1.0 - busy / (tr["t1"] - tr["t0"]))
