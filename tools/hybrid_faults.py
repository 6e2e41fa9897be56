#!/usr/bin/env python3
"""Run the ``gen-hybrid-16k`` cell at its own sizes with each fault that
``portbench/tests/test_portbench_hybrid.py`` injects at a toy size: a
decode step that leaves the Mamba-2 state unchanged, the prefill's conv
state dropped from the cache, the shared expert's output left out.  Each
run is the cell as ``portbench/run.py`` makes it (set-up, a short window,
the check), so the mean gap it prints is read against the cell's own
limit; the sound program first, as the yardstick.

    python3 tools/hybrid_faults.py [--seed N] [--seconds 0.05]

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2 ** 31 + 2027)
    ap.add_argument("--seconds", type=float, default=0.05)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["PYTORCH_NVML_BASED_CUDA_CHECK"] = "1"
    import pytest

    from portbench import run as R
    from portbench.tests.test_portbench_hybrid import FAULTS
    bench, work, conf, spec = R.cell(ROOT, "gen-hybrid-16k")
    for fault in (None,) + FAULTS:
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
