"""End-to-end training example: tiny model, real data pipeline, real
checkpoints, crash-and-resume demonstration.

  PYTHONPATH=src python -m repro_torch.launch.train_smoke [--device cpu]

The port's twin of ``examples/train_smoke.py``: olmo-1b at tiny scale
through ``repro_torch.launch.train`` as a subprocess, 10 steps with
checkpoints every 5, then a second run that resumes from step 10 and
continues to 15.  It runs on the card (``--device cuda``, the default) or
on the CPU.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parents[2]
CMD = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "olmo-1b",
       "--batch", "4", "--seq", "64", "--ckpt-every", "5"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    cmd = CMD + ["--device", args.device]
    path = os.pathsep.join(p for p in (str(SRC), os.environ.get("PYTHONPATH"))
                           if p)
    env = {**os.environ, "PYTHONPATH": path}
    with tempfile.TemporaryDirectory() as d:
        # phase 1: train 10 steps, checkpointing every 5
        r1 = subprocess.run(cmd + ["--steps", "10", "--ckpt", d],
                            env=env, capture_output=True, text=True)
        print(r1.stdout)
        if r1.returncode or "done" not in r1.stdout:
            raise SystemExit(f"training failed:\n{r1.stderr[-4000:]}")
        # phase 2: "crash recovery" — resume and continue to 15
        r2 = subprocess.run(cmd + ["--steps", "15", "--ckpt", d,
                                   "--resume", "auto"],
                            env=env, capture_output=True, text=True)
        print(r2.stdout)
        if (r2.returncode or "resumed from step 10" not in r2.stdout
                or "step=15" not in r2.stdout):
            raise SystemExit(f"resume failed:\n{r2.stderr[-4000:]}")
    print("train + crash-resume ok")


if __name__ == "__main__":
    main()
