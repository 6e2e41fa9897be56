"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in the checkout's ``BENCHMARK.json``;
its configuration file is named there, its traffic is
``portbench/traffic/<cell>.json``, and each per-layer metric is read by
``portbench/metrics/<metric>.py``.  The configuration's ``driver`` names
the code that runs it (``portbench/drivers/<driver>.py``).  With
``--trace 0`` the last line of standard output is the cell's end-to-end
metrics; with ``--trace 1``, its per-layer metrics and the device's busy
time.  Every run checks what the timed path produced against the plain
reference once the window has closed; the numbers compared and their
limits are the last lines of standard error and the last key of the
result.

``--readings 1`` also reads the control (the reference in the next
precision below the configuration's) at the same positions, judges it by
the same check, and prints both readings and the control's own
``correct``; the benchmark's own runs never ask for it.

Exits non-zero with no result when there is no CUDA device, or fewer than
the cell asks for, or when the JAX package or JAX is loaded.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import importlib
import importlib.util
import json
import os
import shutil
import signal
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Optional

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """When this process started, on ``time.perf_counter``'s clock."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        started = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
    return time.perf_counter() - age


T_START = process_start()


@dataclasses.dataclass
class Job:
    """One run: what it runs and how, and where it keeps its files."""
    workload: Dict
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    run_dir: str
    device: str = "cuda"
    pin: bool = True
    fault: Optional[Callable] = None
    t_open: Optional[float] = None

    def setup_done(self, t: float) -> None:
        self.t_open = t


def load_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def cell(root: Path, name: str):
    """(workload entry, configuration, traffic) of cell ``name``."""
    bench = load_json(root / "BENCHMARK.json")
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == work["config"])
    conf = load_json(root / conf_entry["file"])
    spec = load_json(root / "portbench" / "traffic" / f"{name}.json")
    return bench, work, conf, spec


def reader(root: Path, metric: str):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def device_summary(data: Dict) -> Dict:
    """busy_s, window_s and the breakdown of a traced window: the device
    operations that took most time, and the idle gaps by what the host was
    doing when each began."""
    from portbench import stats
    tr = data["device_trace"]
    t0, t1 = tr["t0"], tr["t1"]
    ivs = [(s, s + d) for _, s, d in tr["ops"]]
    busy = stats.covered(ivs, t0, t1)
    by_name: Dict[str, float] = {}
    for name, s, d in tr["ops"]:
        lo, hi = max(s, t0), min(s + d, t1)
        if hi > lo:
            key = name[:96]
            by_name[key] = by_name.get(key, 0.0) + hi - lo
    gaps: Dict[str, float] = {}
    phases = sorted(tr.get("phases", []), key=lambda p: p[1])
    starts = [p[1] for p in phases]
    edge = t0
    for a, b in stats.merge(ivs) + [(t1, t1)]:
        lo, hi = max(edge, t0), min(a, t1)
        if hi > lo:
            gaps[_doing(phases, starts, lo)] = (
                gaps.get(_doing(phases, starts, lo), 0.0) + hi - lo)
        edge = max(edge, b)
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy, "window_s": t1 - t0,
            "breakdown": {"device_ops": top(by_name),
                          "idle_gaps": top(gaps)}}


def _doing(phases, starts, t: float, look: int = 64) -> str:
    """The label of the latest-started host span that covers ``t`` (among
    the ``look`` that started last before it), or "none"."""
    i = bisect.bisect_right(starts, t)
    for p in reversed(phases[max(0, i - look):i]):
        if t < p[2]:
            return p[0]
    return "none"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--readings", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # nothing from outside the run switches the program's injection or
    # tracing on; the card is asked for through NVML, which leaves CUDA
    # uninitialised in this process (the engine forks its workers)
    for var in ("REPRO_INJECT", "REPRO_TRACE"):
        os.environ.pop(var, None)
    os.environ["PYTORCH_NVML_BASED_CUDA_CHECK"] = "1"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    bench, work, conf, spec = cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < work["chips"]:
        print(f"portbench: needs {work['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    run_dir = tempfile.mkdtemp(prefix="portbench-")
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        job = Job(work, conf, spec, args.seed, args.seconds,
                  bool(args.trace), run_dir)
        result = measure(bench, job, readings=bool(args.readings))
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def measure(bench: Dict, job: Job, readings: bool = False) -> Dict:
    """Run the cell, read its metrics, check its output; the result line
    as a dict."""
    import torch
    driver = importlib.import_module(
        f"portbench.drivers.{job.config['driver']}")
    data = driver.run(job)
    name = job.workload["name"]
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}

    def applies(m):
        return name in m.get("workloads", [name])

    metrics: Dict[str, Dict] = {}
    if job.trace:
        for m in bench["per_layer"]:
            if applies(m):
                value = reader(ROOT, m["name"])(data, job)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = driver.end_to_end(data)
        for m in bench["end_to_end"]:
            if m["name"] != "setup_s" and applies(m):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": units[m["name"]]}
        metrics["setup_s"] = {"value": job.t_open - T_START, "unit": "s"}
    device = {"platform": "gpu" if job.device == "cuda" else job.device,
              "kind": data.get("device_name"), "count": job.workload["chips"],
              "memory_peak_bytes": data.get("memory_peak_bytes")}
    extra = {}
    if job.trace and "device_trace" in data:
        summary = device_summary(data)
        device.update(busy_s=summary["busy_s"],
                      window_s=summary["window_s"])
        extra["breakdown"] = summary["breakdown"]
    # the program's state is gone: the reference runs in float32 on the
    # device the program ran on, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(job.device)
    t_check = time.perf_counter()
    outcome = driver.check(data, job.config, job.traffic, job.seed, dev,
                           readings=readings)
    check_s = time.perf_counter() - t_check
    attempted, failed = driver.attempts(data)
    result = {"correct": bool(outcome["correct"]), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device,
              **extra, **driver.notes(data),
              "checked_tokens": outcome["checked_tokens"],
              "check_s": check_s}
    if readings:
        result["readings"] = outcome.get("readings")
        result["control"] = outcome.get("control")
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in outcome["checks"]}
    return result


if __name__ == "__main__":
    sys.exit(main())
