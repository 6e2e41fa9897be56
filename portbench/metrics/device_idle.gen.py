"""The card, in a model-path cell: the share of the traced batch's window
not covered by the union of its device operations' intervals, in %, from
``torch.profiler``.  Moves ``gen_tok_s``."""
from portbench import stats


def read(data, job):
    tr = data.get("device_trace")
    if not tr or not tr["ops"]:
        return None
    busy = stats.covered([(s, s + d) for _, s, d in tr["ops"]],
                         tr["t0"], tr["t1"])
    return 100.0 * (1.0 - busy / (tr["t1"] - tr["t0"]))
