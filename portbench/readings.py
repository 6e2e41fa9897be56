"""Read a cell's correctness numbers and its control's over many seeds in
one process, to set the cell's limits.

    python3 portbench/readings.py --workload <cell> --seeds 41,42,... \
        [--seconds 0.05]

Each seed is a run of the cell as ``run.py`` makes it (set-up, a short
window at the cell's own sizes, the check), with the control read at the
same positions; one JSON line a seed.  A measuring tool: the benchmark's
runs never call it.
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
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.05)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["PYTORCH_NVML_BASED_CUDA_CHECK"] = "1"
    from portbench import run as R
    bench, work, conf, spec = R.cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        run_dir = tempfile.mkdtemp(prefix="portbench-readings-")
        try:
            job = R.Job(work, conf, spec, seed, args.seconds, False, run_dir)
            res = R.measure(bench, job, readings=True)
        finally:
            shutil.rmtree(run_dir, ignore_errors=True)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "program": res["readings"],
                          "control": res["control"],
                          "checked_tokens": res["checked_tokens"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
