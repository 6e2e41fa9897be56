"""Autoscaling signals from CPU-starvation metrics.

The paper's cluster study shows the cheap fix for CPU-induced slowdowns
is usually *more replicas or more cores*, not more GPUs — but only when
the starvation is detected as starvation.  ``FleetAutoscaler`` consumes
the metrics this repo already collects (``core.cpuutil`` saturation
share, scheduler timeout/preemption counters, KV pressure) and emits
scale recommendations.

Deliberately signal-only: it never spawns or kills replicas.  The DES
benchmark and ``launch/serve`` print the recommendation next to the
measurements; an operator (or a future controller) acts on it.

A replica is **starved** when any sustained condition holds:

* CPU saturation share >= ``saturation_high`` (control plane is the
  bottleneck — the paper's headline symptom), or
* timeout rate >= ``timeout_rate_high`` (clients give up before the
  first token), or
* KV pressure >= ``kv_pressure_high`` together with preemption churn
  (the replica is thrashing its cache, every admission evicts).

Scale-up triggers after ``window`` consecutive observations with any
replica starved; scale-down after ``window`` consecutive observations
with *every* replica idle (all signals under the low watermarks).
Hysteresis between the high/low watermarks plus the sustained-window
requirement keeps recommendations from flapping on transient bursts.

Copied from ``src/repro/fleet/autoscale.py``, with its imports rewritten to
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.serving.scheduler import PressureStats


@dataclasses.dataclass(frozen=True)
class ReplicaSignals:
    """One replica's windowed starvation signals (rates, not counters)."""
    cpu_saturation: float = 0.0   # fraction of window spent CPU-saturated
    timeout_rate: float = 0.0     # timeouts / requests resolved in window
    preempt_rate: float = 0.0     # evictions / requests resolved in window
    kv_pressure: float = 0.0

    @classmethod
    def from_stats(cls, prev: Optional[PressureStats], cur: PressureStats,
                   n_resolved: int) -> "ReplicaSignals":
        """Difference two pressure snapshots into window rates.
        ``n_resolved``: requests that finished or timed out in between."""
        d_timeout = cur.n_timed_out - (prev.n_timed_out if prev else 0)
        d_preempt = cur.n_preempted - (prev.n_preempted if prev else 0)
        denom = max(1, n_resolved)
        return cls(cpu_saturation=cur.cpu_saturation,
                   timeout_rate=d_timeout / denom,
                   preempt_rate=d_preempt / denom,
                   kv_pressure=cur.kv_pressure)


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    saturation_high: float = 0.90
    saturation_low: float = 0.30
    timeout_rate_high: float = 0.02
    preempt_rate_high: float = 0.50
    kv_pressure_high: float = 0.95
    window: int = 3                 # consecutive observations before acting
    min_replicas: int = 1
    max_replicas: int = 64
    scale_step: int = 1


@dataclasses.dataclass(frozen=True)
class Recommendation:
    action: str                     # scale_up | scale_down | hold
    n_replicas: int                 # current fleet size
    target: int                     # recommended fleet size
    reason: str


class FleetAutoscaler:
    def __init__(self, n_replicas: int,
                 cfg: AutoscalerConfig = AutoscalerConfig()):
        self.n = n_replicas
        self.cfg = cfg
        self._starved_streak = 0
        self._idle_streak = 0
        self._last_reason = ""

    def _starved(self, s: ReplicaSignals) -> Optional[str]:
        c = self.cfg
        if s.cpu_saturation >= c.saturation_high:
            return (f"cpu saturation {s.cpu_saturation:.2f} >= "
                    f"{c.saturation_high:.2f}")
        if s.timeout_rate >= c.timeout_rate_high:
            return (f"timeout rate {s.timeout_rate:.3f} >= "
                    f"{c.timeout_rate_high:.3f}")
        if (s.kv_pressure >= c.kv_pressure_high
                and s.preempt_rate >= c.preempt_rate_high):
            return (f"kv pressure {s.kv_pressure:.2f} with preemption "
                    f"churn {s.preempt_rate:.2f}")
        return None

    def _idle(self, s: ReplicaSignals) -> bool:
        c = self.cfg
        return (s.cpu_saturation <= c.saturation_low
                and s.timeout_rate == 0.0
                and s.kv_pressure < c.kv_pressure_high)

    def observe(self, signals: Sequence[ReplicaSignals]) -> Recommendation:
        """Feed one observation window; returns the current recommendation
        (``hold`` until a streak of ``window`` observations agrees)."""
        assert len(signals) == self.n, "one ReplicaSignals per replica"
        c = self.cfg
        reasons = [self._starved(s) for s in signals]
        starved = [i for i, r in enumerate(reasons) if r is not None]
        if starved:
            self._starved_streak += 1
            self._idle_streak = 0
            self._last_reason = (f"replica {starved[0]}: "
                                 f"{reasons[starved[0]]}")
        elif all(self._idle(s) for s in signals):
            self._idle_streak += 1
            self._starved_streak = 0
        else:
            self._starved_streak = 0
            self._idle_streak = 0

        if (self._starved_streak >= c.window
                and self.n < c.max_replicas):
            return Recommendation(
                "scale_up", self.n,
                min(c.max_replicas, self.n + c.scale_step),
                f"{self._starved_streak} consecutive windows starved "
                f"({self._last_reason})")
        if (self._idle_streak >= c.window
                and self.n > c.min_replicas):
            return Recommendation(
                "scale_down", self.n,
                max(c.min_replicas, self.n - c.scale_step),
                f"{self._idle_streak} consecutive windows idle on all "
                f"replicas")
        return Recommendation("hold", self.n, self.n,
                              "no sustained signal")

    def resize(self, n_replicas: int) -> None:
        """Caller acted on a recommendation; reset streaks for the new
        fleet size."""
        self.n = n_replicas
        self._starved_streak = 0
        self._idle_streak = 0
