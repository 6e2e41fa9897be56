"""API server and tokenizer pool (``ServingSystem.submit``,
``tokenizer.pool``): the mean over the window's answered requests of
``t_tokenize_done - t_arrival`` from the engine's request records, the
wait for a pool thread included.  Moves ``tpot_p50_ms``: the pool's
threads share the cell's cores with the engine and the workers."""


def read(data, job):
    waits = [r["t_tokenize_done"] - r["t_arrival"]
             for r in data["results"].values()
             if r and r.get("t_tokenize_done")]
    return sum(waits) / len(waits) * 1e3 if waits else None
