"""SLO latency classes for mixed-class serving traffic (docs/slo.md).

Real fleets mix interactive chat, batch summarization, and background
agents.  The paper shows CPU starvation hits tail latency first — TTFT
timeouts appear long before throughput collapses — so one batch job's
long prompt can blow an interactive request's TTFT budget even when the
scheduler has headroom.  This module defines the latency-class model the
rest of the stack keys off:

- ``SLOClass``: a frozen bundle of TTFT/TPOT targets, a per-class client
  timeout, a preemption rank (lower = evicted first), and an optional
  per-class ``prefill_chunk`` cap.
- presets ``INTERACTIVE`` / ``STANDARD`` / ``BATCH`` + a registry for
  ``--slo-mix interactive:0.3,batch:0.7`` style specs.
- ``SLOMix``: deterministic largest-remainder assigner so workload
  generators tag requests in exact mix proportions without RNG.
- ``slo_summary``: post-hoc per-class attainment accounting from request
  timelines — the same definitions the scheduler tracks incrementally in
  ``Scheduler.pressure_stats().slo``, so DES, live engine, and offline
  analysis agree.

Untagged requests (``Request.slo is None``) are treated as STANDARD for
scheduling decisions but are excluded from attainment accounting; with a
single class present the scheduler's plans are bit-identical to the
class-blind path (pinned in tests/test_slo.py).

Copied from ``src/repro/slo/__init__.py``, with its imports
rewritten to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "SLOClass",
    "INTERACTIVE",
    "STANDARD",
    "BATCH",
    "PRESETS",
    "get_class",
    "parse_slo_mix",
    "SLOMix",
    "tag_request",
    "slack_bucket",
    "SLACK_BUCKETS",
    "slo_summary",
]


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A latency class: targets + the knobs schedulers key off.

    ``rank`` is the preemption rank: lower ranks are evicted/shed before
    higher ones (batch=0 < standard=1 < interactive=2).  ``prefill_chunk``
    (0 = scheduler default) caps this class's per-step prefill chunk so a
    batch prompt can't monopolize a step an interactive request is queued
    behind.  ``timeout`` (0 = caller's global default) becomes the
    per-request client timeout when the class is applied.
    """

    name: str
    ttft_target: float             # seconds from arrival to first token
    tpot_target: float             # seconds per decode token (steady state)
    timeout: float = 0.0           # per-class client timeout (0 = global)
    rank: int = 1                  # preemption rank; lower evicted first
    prefill_chunk: int = 0         # per-class chunk cap (0 = scheduler cfg)

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("SLOClass needs a name")
        if self.ttft_target <= 0 or self.tpot_target <= 0:
            raise ValueError("SLO targets must be positive")
        if self.timeout < 0 or self.prefill_chunk < 0:
            raise ValueError("timeout/prefill_chunk must be >= 0")

    # -- wire encode/decode (engine in_q dicts, JSON artifacts) ---------
    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "SLOClass":
        return cls(**d)  # type: ignore[arg-type]


INTERACTIVE = SLOClass("interactive", ttft_target=1.0, tpot_target=0.1,
                       timeout=30.0, rank=2)
STANDARD = SLOClass("standard", ttft_target=5.0, tpot_target=0.25,
                    timeout=120.0, rank=1)
BATCH = SLOClass("batch", ttft_target=60.0, tpot_target=1.0,
                 timeout=600.0, rank=0, prefill_chunk=512)

PRESETS: Dict[str, SLOClass] = {
    c.name: c for c in (INTERACTIVE, STANDARD, BATCH)
}


def get_class(name: str) -> SLOClass:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(
            f"unknown SLO class {name!r} (presets: {sorted(PRESETS)})"
        ) from None


def parse_slo_mix(spec: str) -> List[Tuple[SLOClass, float]]:
    """Parse ``"interactive:0.3,batch:0.7"`` into [(class, weight), ...].

    Weights are normalized; a bare name means weight 1.  Raises on
    unknown class names or non-positive weights.
    """
    out: List[Tuple[SLOClass, float]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, _, w = part.partition(":")
            weight = float(w)
        else:
            name, weight = part, 1.0
        if weight <= 0:
            raise ValueError(f"slo-mix weight must be > 0: {part!r}")
        out.append((get_class(name.strip()), weight))
    if not out:
        raise ValueError(f"empty slo-mix spec: {spec!r}")
    total = sum(w for _, w in out)
    return [(c, w / total) for c, w in out]


class SLOMix:
    """Deterministic proportional class assigner (largest remainder).

    Each call to :meth:`next` credits every class its weight and emits
    the class with the largest accumulated debt — exact proportions with
    no RNG, so DES runs and conformance tests stay reproducible.
    """

    def __init__(self, mix: Sequence[Tuple[SLOClass, float]]):
        if not mix:
            raise ValueError("empty mix")
        total = sum(w for _, w in mix)
        self.classes = [c for c, _ in mix]
        self.weights = [w / total for _, w in mix]
        self._debt = [0.0] * len(mix)

    def next(self) -> SLOClass:
        for i, w in enumerate(self.weights):
            self._debt[i] += w
        pick = max(range(len(self._debt)), key=lambda i: (self._debt[i], -i))
        self._debt[pick] -= 1.0
        return self.classes[pick]


def tag_request(req, cls: Optional[SLOClass]):
    """Apply a class to a request: sets ``req.slo`` and defaults
    ``req.timeout`` from the class (an explicit per-request timeout wins)."""
    if cls is None:
        return req
    req.slo = cls
    if cls.timeout > 0 and req.timeout is None:
        req.timeout = cls.timeout
    return req


# -- slack histograms ------------------------------------------------------

SLACK_BUCKETS: Tuple[str, ...] = (
    "<-10s", "-10..-1s", "-1..0s", "0..1s", "1..10s", ">10s",
)


def slack_bucket(slack: float) -> str:
    """Bucket a TTFT slack sample (deadline - first_token; <0 = missed)."""
    if slack < -10.0:
        return SLACK_BUCKETS[0]
    if slack < -1.0:
        return SLACK_BUCKETS[1]
    if slack < 0.0:
        return SLACK_BUCKETS[2]
    if slack < 1.0:
        return SLACK_BUCKETS[3]
    if slack < 10.0:
        return SLACK_BUCKETS[4]
    return SLACK_BUCKETS[5]


# -- post-hoc attainment accounting ---------------------------------------

def slo_summary(requests: Iterable) -> Dict[str, Dict[str, object]]:
    """Per-class SLO attainment from request timelines.

    Definitions (mirrored by the scheduler's incremental counters so the
    DES snapshot, the live engine stats stream, and this post-hoc pass
    agree — pinned in tests/test_slo.py):

    - ``n_first`` / ``n_ttft_ok``: requests that produced a first token;
      attained when ``t_first_token - t_arrival <= ttft_target``.
    - ``n_tpot_sample`` / ``n_tpot_ok``: finished requests with >= 2
      generated tokens; attained when the mean inter-token time
      ``(t_done - t_first_token) / (n_generated - 1) <= tpot_target``.
    - ``n_timeouts``: requests that ended TIMED_OUT.
    - ``slack_hist``: bucketed ``deadline - t_first_token`` samples.

    Untagged requests are skipped.
    """
    from repro_torch.serving.request import RequestState

    out: Dict[str, Dict[str, object]] = {}
    for req in requests:
        cls = getattr(req, "slo", None)
        if cls is None:
            continue
        acct = out.setdefault(cls.name, {
            "rank": cls.rank, "n": 0, "n_first": 0, "n_ttft_ok": 0,
            "n_done": 0, "n_tpot_sample": 0, "n_tpot_ok": 0,
            "n_timeouts": 0, "slack_hist": {},
        })
        acct["n"] += 1
        if req.t_first_token:
            acct["n_first"] += 1
            slack = (req.t_arrival + cls.ttft_target) - req.t_first_token
            if slack >= 0:
                acct["n_ttft_ok"] += 1
            hist = acct["slack_hist"]
            b = slack_bucket(slack)
            hist[b] = hist.get(b, 0) + 1
        if req.state == RequestState.FINISHED:
            acct["n_done"] += 1
            n_gen = len(req.generated)
            if req.t_first_token and n_gen >= 2:
                acct["n_tpot_sample"] += 1
                tpot = (req.t_done - req.t_first_token) / (n_gen - 1)
                if tpot <= cls.tpot_target:
                    acct["n_tpot_ok"] += 1
        elif req.state == RequestState.TIMED_OUT:
            acct["n_timeouts"] += 1
    for acct in out.values():
        n_first = acct["n_first"]
        n_tpot = acct["n_tpot_sample"]
        acct["ttft_attainment"] = (
            acct["n_ttft_ok"] / n_first if n_first else None)
        acct["tpot_attainment"] = (
            acct["n_tpot_ok"] / n_tpot if n_tpot else None)
    return out
