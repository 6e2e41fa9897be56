"""Find a serving cell's knee: the highest offered rate at which 90% of
requests meet both latency limits and the backlog does not grow.

    python3 portbench/sweep.py --workload <cell> --seed <n> \
        --seconds <per rate> --rates 2,20,40,...

One engine, built and warmed as a run of the cell builds it, serves a
window at each rate in turn (lowest first), draining between them.  The
first rate is taken as the unloaded one: the limits are ``--ttft-x`` and
``--tpot-x`` times its median TTFT and TPOT.  Prints one row per rate and
a last JSON line with the table.  A measuring tool: the benchmark's runs
never call it.
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--ttft-x", type=float, default=5.0)
    ap.add_argument("--tpot-x", type=float, default=5.0)
    ap.add_argument("--limits-ms", default="",
                    help="TTFT,TPOT limits in ms; default: from the first "
                         "rate")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import os
    os.environ["PYTORCH_NVML_BASED_CUDA_CHECK"] = "1"
    from portbench import run as R, stats, traffic
    from portbench.drivers import serve
    from repro_torch.core.engine import ServingSystem

    bench, work, conf, spec = R.cell(ROOT, args.workload)
    serve.pin(conf["cpus"])
    system = ServingSystem(serve.engine_config(conf, trace=False,
                                               device="cuda"))
    rows, limits = [], None
    if args.limits_ms:
        limits = tuple(float(x) / 1e3 for x in args.limits_ms.split(","))
    try:
        system.start()
        warm: dict = {}
        serve._submit_all(system, traffic.warmup(spec, args.seed),
                          time.perf_counter(), warm, [])
        serve._collect(system, list(warm), time.perf_counter() + 120)
        for rate in [float(r) for r in args.rates.split(",")]:
            sp = dict(copy.deepcopy(spec), rate_rps=rate)
            window = traffic.open_loop(sp, args.seed, args.seconds)
            sent, lag = {}, []
            t_open = time.perf_counter()
            th = threading.Thread(target=serve._submit_all,
                                  args=(system, window, t_open, sent, lag))
            th.start()
            th.join()
            serve._collect(system, list(sent), t_open + args.seconds + 60)
            data = {"sent": sent, "t_open": t_open,
                    "t_close": t_open + args.seconds,
                    "results": {rid: system.results.get(rid)
                                for rid in sent}}
            e2e = serve.end_to_end(data)
            ttft, tpot = [], []
            for rid, (_, due) in sorted(sent.items(), key=lambda kv: kv[1][1]):
                r = data["results"][rid]
                if not serve._answered(r):
                    ttft.append(stats.MISSING)
                    tpot.append(stats.MISSING)
                    continue
                n = r["n_generated"]
                ttft.append(r["t_first_token"] - due)
                tpot.append((r["t_done"] - r["t_first_token"]) / max(n - 1, 1))
            if limits is None:
                limits = (args.ttft_x * statistics.median(ttft),
                          args.tpot_x * statistics.median(tpot))
            met = sum(1 for a, b in zip(ttft, tpot)
                      if a <= limits[0] and b <= limits[1]) / len(ttft)
            third = max(1, len(ttft) // 3)
            growth = (statistics.median(ttft[-third:])
                      / statistics.median(ttft[:third]))
            row = {"rate": rate, "requests": len(sent),
                   "ttft_p50_ms": statistics.median(ttft) * 1e3,
                   "ttft_p95_ms": e2e["ttft_p95_ms"],
                   "tpot_p50_ms": statistics.median(tpot) * 1e3,
                   "tpot_p95_ms": e2e["tpot_p95_ms"],
                   "serve_tok_s": e2e["serve_tok_s"], "met": met,
                   "ttft_last_over_first_third": growth,
                   "sender_lag_p99_ms": stats.percentile(lag, 99) * 1e3}
            rows.append(row)
            print(json.dumps(row), flush=True)
            if met < 0.5:
                break           # far past the knee: the queue only grows
    finally:
        system.shutdown()
    print(json.dumps({"limits_ms": [limits[0] * 1e3, limits[1] * 1e3],
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
