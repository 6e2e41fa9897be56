"""Discrete-event simulator with a processor-sharing CPU model.

The CPU model is generalized processor sharing (GPS) over ``n_cores``:
at any instant the R runnable procs each progress at rate

    rate = min(1, n_cores / R) * eff(R)

where ``eff`` discounts context-switch overhead under oversubscription
(R > cores ⇒ each core time-slices, paying ``cs_cost`` per ``quantum``).
Event-driven: rates only change at proc arrival/completion boundaries, so
between events every runnable proc's remaining work drains linearly.

Wake-up latency: when a blocked/spinning proc's condition fires, it resumes
only after ``wake_latency() = quantum * max(0, (R+1)/cores - 1)`` — an idle
core notices immediately; an oversubscribed box must wait for a time slice.
This single term reproduces the paper's §V-A straggler amplification: one
delayed rank holds the collective barrier for everyone.

Procs are Python generators yielding:
    ("cpu", seconds)     — consume CPU work (subject to sharing)
    ("sleep", seconds)   — wall-clock wait, no CPU (device compute)
    ("wait", event)      — block until event.fire() (+ wake-up latency)
    ("spin", event)      — busy-wait: consumes CPU until event fires

Copied from ``src/repro/sim/core.py``, with its imports rewritten to
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Any, Callable, Dict, Generator, List, Optional, Tuple


class Event:
    __slots__ = ("fired", "t_fired", "waiters", "name")

    def __init__(self, name: str = ""):
        self.fired = False
        self.t_fired = math.inf
        self.waiters: List["Proc"] = []
        self.name = name


@dataclasses.dataclass
class Proc:
    name: str
    gen: Generator
    # phase state
    phase: str = "new"            # cpu | sleep | wait | spin | done
    work_left: float = 0.0        # for cpu
    wake_at: float = math.inf     # for sleep / scheduled wakeup
    event: Optional[Event] = None
    nice: float = 1.0             # relative CPU weight (unused=equal share)
    cpu_used: float = 0.0
    lat_paid: bool = False        # wake-up scheduling latency already added


class Sim:
    def __init__(self, n_cores: float, *, quantum: float = 1e-3,
                 cs_cost: float = 5e-6):
        self.n_cores = float(n_cores)
        self.quantum = quantum
        self.cs_cost = cs_cost
        self.now = 0.0
        self.procs: List[Proc] = []
        self._timers: List[Tuple[float, int, Callable[[], None]]] = []
        self._tie = itertools.count()
        self.util_trace: List[Tuple[float, float]] = []   # (t, busy frac)

    # -- public API ------------------------------------------------------------

    def spawn(self, name: str, gen: Generator) -> Proc:
        p = Proc(name, gen)
        self.procs.append(p)
        self._advance(p, None)
        return p

    def event(self, name: str = "") -> Event:
        return Event(name)

    def fire(self, ev: Event) -> None:
        if ev.fired:
            return
        ev.fired = True
        ev.t_fired = self.now
        lat = self.wake_latency()
        for p in ev.waiters:
            if p.phase in ("wait", "spin"):
                p.phase = "sleep"
                p.wake_at = self.now + lat
                p.lat_paid = True
        ev.waiters.clear()

    def at(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._timers, (t, next(self._tie), fn))

    # -- scheduling model --------------------------------------------------------

    def _runnable(self) -> List[Proc]:
        return [p for p in self.procs if p.phase in ("cpu", "spin")]

    def rate(self, n_runnable: int) -> float:
        if n_runnable == 0:
            return 0.0
        share = min(1.0, self.n_cores / n_runnable)
        if n_runnable > self.n_cores:
            # context-switch tax: each quantum pays cs_cost
            eff = self.quantum / (self.quantum + self.cs_cost
                                  * (n_runnable / self.n_cores))
        else:
            eff = 1.0
        return share * eff

    def wake_latency(self) -> float:
        r = len(self._runnable())
        over = max(0.0, (r + 1) / self.n_cores - 1.0)
        return self.quantum * over

    # -- core loop ---------------------------------------------------------------

    def _advance(self, p: Proc, send: Any) -> None:
        """Run proc p until its next yield."""
        try:
            kind, arg = p.gen.send(send)
        except StopIteration:
            p.phase = "done"
            return
        if kind == "cpu":
            p.phase = "cpu"
            p.work_left = max(float(arg), 0.0)
        elif kind == "sleep":
            p.phase = "sleep"
            p.wake_at = self.now + max(float(arg), 0.0)
        elif kind in ("wait", "spin"):
            ev: Event = arg
            if ev.fired:
                # even an already-satisfied wait costs a scheduling slot
                # when the box is oversubscribed
                p.phase = "sleep"
                p.wake_at = self.now + self.wake_latency()
                p.lat_paid = True
            else:
                p.phase = kind
                p.event = ev
                ev.waiters.append(p)
                if kind == "spin":
                    p.work_left = math.inf
        else:
            raise ValueError(f"unknown phase {kind!r}")

    def run(self, until: float = math.inf, max_events: int = 20_000_000
            ) -> None:
        for i in range(max_events):
            if i % 4096 == 0 and len(self.procs) > 512:
                self.procs = [p for p in self.procs if p.phase != "done"]
            runnable = self._runnable()
            rate = self.rate(len(runnable))

            # next completion among cpu procs
            t_cpu = math.inf
            nxt: Optional[Proc] = None
            for p in runnable:
                if p.phase == "cpu" and rate > 0:
                    t = self.now + p.work_left / rate
                    if t < t_cpu:
                        t_cpu, nxt = t, p
            # next sleeper wakeup
            t_sleep = math.inf
            sleeper: Optional[Proc] = None
            for p in self.procs:
                if p.phase == "sleep" and p.wake_at < t_sleep:
                    t_sleep, sleeper = p.wake_at, p
            # next timer
            t_timer = self._timers[0][0] if self._timers else math.inf

            t_next = min(t_cpu, t_sleep, t_timer)
            if t_next is math.inf or t_next > until:
                # Pausing mid-segment: drain the linear stretch [now, until]
                # before returning so a later run(until=...) resumes with the
                # exact same arithmetic an uninterrupted run would have used —
                # otherwise every in-progress cpu burst is silently stretched
                # by the pause (FleetModel advances replicas in lockstep
                # slices and depends on this).
                if until != math.inf:
                    dt = until - self.now
                    if dt > 0 and rate > 0:
                        for p in runnable:
                            drained = dt * rate
                            p.cpu_used += drained
                            if p.phase == "cpu":
                                p.work_left -= drained
                        if runnable:
                            self.util_trace.append(
                                (self.now,
                                 min(1.0, len(runnable) / self.n_cores)))
                self.now = min(until, max(self.now, until))
                return
            dt = t_next - self.now
            # drain work
            if dt > 0 and rate > 0:
                for p in runnable:
                    drained = dt * rate
                    p.cpu_used += drained
                    if p.phase == "cpu":
                        p.work_left -= drained
                if runnable:
                    self.util_trace.append(
                        (self.now, min(1.0, len(runnable) / self.n_cores)))
            self.now = t_next

            if t_next == t_timer:
                _, _, fn = heapq.heappop(self._timers)
                fn()
            elif t_next == t_cpu and nxt is not None:
                nxt.work_left = 0.0
                self._advance(nxt, None)
            elif sleeper is not None:
                if not sleeper.lat_paid:
                    # timer expiry -> runnable: pay the scheduling delay once
                    lat = self.wake_latency()
                    if lat > 0:
                        sleeper.wake_at = self.now + lat
                        sleeper.lat_paid = True
                        continue
                sleeper.wake_at = math.inf
                sleeper.lat_paid = False
                self._advance(sleeper, None)
        raise RuntimeError("simulation exceeded max_events")

    def saturation_seconds(self, threshold: float = 0.95) -> float:
        """Approximate time spent with runnable/cores >= threshold."""
        total = 0.0
        for (t0, u0), (t1, _) in zip(self.util_trace, self.util_trace[1:]):
            if u0 >= threshold:
                total += t1 - t0
        return total
