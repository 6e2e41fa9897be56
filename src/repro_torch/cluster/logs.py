"""Cluster allocation-log tooling (paper §II-B, Figs 3-4).

The analysis pipeline is real and re-runnable on any sacct/salloc export
(``parse_salloc_log``); the paper's logs are private, so
``synthesize_cluster_log`` generates a dataset matched to every percentile
the paper states (clearly labeled synthetic — see DESIGN.md §9):

  instructional cluster: P50 CPU:GPU ratio in [1, 2]; P25 <= 2; H100 rows
  with 1 core per 4-8 GPUs (P25 = 0.25); H100 ~ 34.3k of 50.9k GPU-hours.
  research cluster: scheduler-enforced proportional default (cores ~
  n_gpus * node_cores / node_gpus) with user overrides; ~60% of jobs on
  some GPU types below ratio 8.

Copied from ``src/repro/cluster/logs.py``, with its imports rewritten to
``repro_torch``.
"""
from __future__ import annotations

import csv
import dataclasses
import io
import random
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class AllocRecord:
    user: str
    gpu_type: str
    n_gpus: int
    n_cpus: int
    hours: float

    @property
    def ratio(self) -> float:
        return self.n_cpus / max(self.n_gpus, 1)

    @property
    def gpu_hours(self) -> float:
        return self.n_gpus * self.hours


def parse_salloc_log(path_or_text: str | Path) -> List[AllocRecord]:
    """CSV columns: user,gpu_type,n_gpus,n_cpus,hours."""
    if isinstance(path_or_text, Path) or "\n" not in str(path_or_text):
        text = Path(path_or_text).read_text()
    else:
        text = str(path_or_text)
    out = []
    for row in csv.DictReader(io.StringIO(text)):
        out.append(AllocRecord(
            user=row["user"], gpu_type=row["gpu_type"],
            n_gpus=int(row["n_gpus"]), n_cpus=int(row["n_cpus"]),
            hours=float(row["hours"])))
    return out


def gpu_hour_weighted_cdf(records: Sequence[AllocRecord],
                          gpu_type: str | None = None
                          ) -> List[Tuple[float, float]]:
    """CDF of CPU:GPU ratio weighted by GPU-hours (the Figs 3-4 curves)."""
    rows = [r for r in records if gpu_type is None or r.gpu_type == gpu_type]
    if not rows:
        return []
    rows.sort(key=lambda r: r.ratio)
    total = sum(r.gpu_hours for r in rows)
    acc, out = 0.0, []
    for r in rows:
        acc += r.gpu_hours
        out.append((r.ratio, acc / total))
    return out


def percentile_of(cdf: List[Tuple[float, float]], p: float) -> float:
    for ratio, frac in cdf:
        if frac >= p:
            return ratio
    return cdf[-1][0] if cdf else float("nan")


def synthesize_cluster_log(kind: str = "instructional", n: int = 4000,
                           seed: int = 0) -> List[AllocRecord]:
    rng = random.Random(seed)
    out: List[AllocRecord] = []
    if kind == "instructional":
        # mixture tuned to the paper's percentiles (P50 ~ 1-2, P25 <= 2,
        # H100 P25 = 0.25 via 1-core/4-8-GPU jobs, H100 ~ 2/3 of GPU-hours)
        for i in range(n):
            gpu_type = rng.choices(["H100", "A100", "RTX6000"],
                                   weights=[0.55, 0.3, 0.15])[0]
            bucket = rng.random()
            # bucket probabilities chosen so the GPU-HOUR-weighted CDF hits
            # the paper's percentiles (multi-GPU 1-core jobs carry ~6x the
            # gpu-hour weight of single-GPU jobs)
            b1 = 0.155 if gpu_type == "H100" else 0.03
            if bucket < b1:
                n_gpus = rng.choice([4, 8])
                n_cpus = 1                       # --cpus-per-task default!
            elif bucket < b1 + 0.55:
                n_gpus = rng.choice([1, 2, 4])
                n_cpus = n_gpus * rng.choice([1, 2])
            elif bucket < b1 + 0.80:
                n_gpus = rng.choice([1, 2, 4])
                n_cpus = n_gpus * rng.choice([4, 6, 8])
            else:
                n_gpus = rng.choice([1, 2])
                n_cpus = n_gpus * rng.choice([12, 16])
            hours = rng.lognormvariate(0.5, 1.0)
            if gpu_type == "H100":
                hours *= 1.8                     # H100 dominates GPU-hours
            out.append(AllocRecord(f"u{i%211}", gpu_type, n_gpus,
                                   max(1, n_cpus), hours))
    elif kind == "research":
        # enforced proportional default (node: 64 cores / 8 GPUs = 8/GPU),
        # with a tail of users overriding downward
        for i in range(n):
            gpu_type = rng.choices(["H200", "A100", "V100"],
                                   weights=[0.4, 0.4, 0.2])[0]
            n_gpus = rng.choice([1, 1, 2, 4, 8])
            if rng.random() < 0.6:
                per = rng.choice([4, 6, 7])      # below-8 majority
            else:
                per = rng.choice([8, 8, 12, 16])
            out.append(AllocRecord(f"r{i%97}", gpu_type, n_gpus,
                                   max(1, n_gpus * per),
                                   rng.lognormvariate(0.8, 1.0)))
    else:
        raise ValueError(kind)
    return out


def to_csv(records: Iterable[AllocRecord]) -> str:
    buf = io.StringIO()
    w = csv.writer(buf)
    w.writerow(["user", "gpu_type", "n_gpus", "n_cpus", "hours"])
    for r in records:
        w.writerow([r.user, r.gpu_type, r.n_gpus, r.n_cpus, f"{r.hours:.3f}"])
    return buf.getvalue()
