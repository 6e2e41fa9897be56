"""Model entry point ``Model.prefill``: the mean over the window's
batches of the prefill call's time between CUDA events, in ms.  Moves
``gen_tok_s``."""


def read(data, job):
    ms = data.get("prefill_ms")
    return sum(ms) / len(ms) if ms else None
