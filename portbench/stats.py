"""Arithmetic of the benchmark's metrics: tails over every request, spans
in a window, unions of intervals, spreads."""
from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Optional, Sequence, Tuple

MISSING = math.inf


def percentile(values: Sequence[float], p: float) -> float:
    """The ``p``-th percentile (0 < p <= 100) by nearest rank over every
    value; a request that never answered is ``MISSING`` and sorts last."""
    if not values:
        raise ValueError("percentile of no values")
    v = sorted(values)
    rank = max(1, math.ceil(p / 100.0 * len(v)))
    return v[rank - 1]


def mean(values: Iterable[float]) -> Optional[float]:
    v = list(values)
    return sum(v) / len(v) if v else None


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles``, exclusive method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def merge(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def covered(intervals: Iterable[Tuple[float, float]], t0: float,
            t1: float) -> float:
    """Seconds of [t0, t1] that the union of ``intervals`` covers."""
    total = 0.0
    for a, b in merge(intervals):
        lo, hi = max(a, t0), min(b, t1)
        if hi > lo:
            total += hi - lo
    return total


def in_window(spans: Iterable, t0: float, t1: float) -> list:
    """The spans (objects with ``t0`` and ``dur``) that start in
    [t0, t1)."""
    return [s for s in spans if t0 <= s.t0 < t1]


def tokens_in_window(t_first: float, t_done: float, n: int, t0: float,
                     t1: float) -> float:
    """How many of a request's ``n`` tokens came in [t0, t1]: the first at
    ``t_first``, the other ``n - 1`` spread evenly over (t_first,
    t_done]."""
    if n <= 0:
        return 0.0
    got = 1.0 if t0 <= t_first <= t1 else 0.0
    if n > 1 and t_done > t_first:
        lo, hi = max(t_first, t0), min(t_done, t1)
        if hi > lo:
            got += (n - 1) * (hi - lo) / (t_done - t_first)
    elif n > 1 and t0 <= t_done <= t1:
        got += n - 1
    return got
