"""CPU utilization sampling from /proc/stat (Figs 10-11 instrumentation).

Copied from ``src/repro/core/cpuutil.py``, with its imports
rewritten to ``repro_torch``.
"""
from __future__ import annotations

import threading
import time
from typing import List, Tuple


def _read_proc_stat() -> Tuple[float, float]:
    with open("/proc/stat") as f:
        parts = f.readline().split()
    vals = [float(v) for v in parts[1:]]
    idle = vals[3] + (vals[4] if len(vals) > 4 else 0.0)   # idle + iowait
    return sum(vals), idle


class CpuSampler:
    """Background thread sampling aggregate CPU busy fraction."""

    def __init__(self, interval: float = 0.05):
        self.interval = interval
        self.samples: List[Tuple[float, float]] = []   # (t, busy_frac)
        # actual wall seconds each sample covers: under CPU starvation —
        # the very regime this sampler exists to measure — the sampling
        # thread itself gets descheduled and wakes late, so assuming
        # ``interval`` per sample undercounts saturated time exactly when
        # it matters most
        self._spans: List[float] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def __enter__(self) -> "CpuSampler":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        total0, idle0 = _read_proc_stat()
        t_prev = time.perf_counter()
        while not self._stop.wait(self.interval):
            total1, idle1 = _read_proc_stat()
            now = time.perf_counter()
            dt, di = total1 - total0, idle1 - idle0
            if dt > 0:
                self.samples.append((now, 1.0 - di / dt))
                self._spans.append(now - t_prev)
            total0, idle0 = total1, idle1
            t_prev = now

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def saturation_seconds(self, threshold: float = 0.95) -> float:
        """Total time spent at >= threshold utilization (Fig. 10 metric),
        weighted by each sample's measured inter-sample wall time, not
        the nominal interval (late wake-ups stretch the window a busy
        sample covers)."""
        return sum(span for (_, b), span in zip(self.samples, self._spans)
                   if b >= threshold)


def cpu_budget(n_cores: int) -> int:
    """Restrict this process (and future children) to ``n_cores`` logical
    CPUs — the paper's salloc-style CPU allocation.  Returns the number of
    cores actually available (this container exposes one)."""
    import os
    avail = sorted(os.sched_getaffinity(0))
    take = avail[: max(1, min(n_cores, len(avail)))]
    os.sched_setaffinity(0, take)
    return len(take)
