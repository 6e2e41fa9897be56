#!/usr/bin/env python3
"""Run a model-path cell at its own sizes with each fault that its toy
test injects (``FAULTS``): ``gen-hybrid-16k`` those of
``portbench/tests/test_portbench_hybrid.py`` (a decode step that leaves
the Mamba-2 state unchanged, the prefill's conv state dropped from the
cache, the shared expert's output left out), ``gen-mla-32k`` those of
``portbench/tests/test_portbench_mla.py`` (a decode step's latent slot
left unwritten, ``k_pe`` not rotated, the experts' gates renormalised).
Each run is the cell as ``portbench/run.py`` makes it (set-up, a short
window, the check), so the mean gap it prints is read against the cell's
own limit; the sound program first, as the yardstick.

    python3 tools/hybrid_faults.py [--workload gen-hybrid-16k] [--seed N] \
        [--seconds 0.05] [--runs sound,slot_unwritten,...]

One JSON line a run: the fault (``null`` for the sound program),
``correct``, the mean gap and its limit, the served positions checked.
Needs a CUDA device.  A measuring tool: the benchmark's runs never call
it.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TESTS = {"gen-hybrid-16k": "test_portbench_hybrid",
         "gen-mla-32k": "test_portbench_mla"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=sorted(TESTS),
                    default="gen-hybrid-16k")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 2027)
    ap.add_argument("--seconds", type=float, default=0.05)
    ap.add_argument("--runs", help="the runs to make, by name: sound and "
                    "the faults' names without their underscore (default: "
                    "all, the sound program first)")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["PYTORCH_NVML_BASED_CUDA_CHECK"] = "1"
    import importlib

    import pytest

    from portbench import run as R
    FAULTS = importlib.import_module(
        f"portbench.tests.{TESTS[args.workload]}").FAULTS
    bench, work, conf, spec = R.cell(ROOT, args.workload)
    runs = (None,) + FAULTS
    if args.runs:
        by_name = {f and f.__name__.lstrip("_") or "sound": f for f in runs}
        runs = tuple(by_name[n] for n in args.runs.split(","))
    for fault in runs:
        run_dir = tempfile.mkdtemp(prefix="hybrid-faults-")
        try:
            with pytest.MonkeyPatch.context() as mp:
                if fault is not None:
                    fault(mp)
                job = R.Job(work, conf, spec, args.seed, args.seconds,
                            False, run_dir)
                res = R.measure(bench, job)
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)
        gap = res["checks"]["mean_gap"]
        print(json.dumps({"fault": fault and fault.__name__.lstrip("_"),
                          "seed": args.seed, "correct": res["correct"],
                          "mean_gap": gap["value"], "limit": gap["limit"],
                          "checked_tokens": res.get("checked_tokens")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
