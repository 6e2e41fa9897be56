"""Speed-bump critical-path harness: slowdown injection + trace timeline.

"Time spent ≠ time that matters."  A profiler tells you where CPU cycles
go; it cannot tell you which of those cycles the GPUs are *waiting on*.
The speed-bump methodology (SonicField/speed-bump, ROADMAP item 3)
answers that directly: artificially slow ONE control-plane module by a
calibrated delay and measure how throughput responds.  A module whose
slowdown doesn't move throughput is off the critical path no matter how
hot it looks; the fitted sensitivity slope (relative throughput loss per
injected microsecond) ranks the modules that actually gate the devices —
per CPU allocation, because the ranking shifts as cores get scarce
(the paper's thesis, now an executable measurement).

Two cooperating halves:

* **Slowdown injector** — named injection ``SITES`` wrap the
  control-plane choke points (scheduler step, tokenizer pool encode /
  decode, shm broadcast encode / publish, copy-engine submission,
  block-manager allocation, worker dispatch).  A spec string
  ``"site=delay_us,..."`` (``*`` = every site) selects the delays, from
  the ``REPRO_INJECT`` env var, a ``ProfilingConfig``, or
  ``serve --inject``.  The same sites charge in two modes:

    - **wall** (the live multi-process engine): ``time.sleep`` at the
      site, inside the traced span — the module really gets slower;
    - **virtual** (the DES): delays accumulate in ``Profiler.pending``
      and the sim procs drain them as extra ``("cpu", s)`` work — the
      GPS model then prices the slowdown under the exact core budget
      being swept, deterministically and fast.  ``drain()`` returns 0.0
      when nothing was charged and the procs skip the yield entirely, so
      a delay-0 (or absent) profiler is *bit-exact* with no profiler at
      all — the zero-overhead oracle tests/test_profiling.py pins.

* **Trace timeline** — structured span events (site, t_start, duration,
  step id, request id) appended lock-free to a per-process list (one
  profiler per engine/worker process; list.append is atomic under the
  GIL, no lock on the hot path).  Merged across processes at shutdown
  (timestamps are CLOCK_MONOTONIC, shared machine-wide on Linux) and
  exported as Chrome/Perfetto ``trace_event`` JSON plus a text
  critical-path summary: per site, total span time and the share NOT
  hidden behind device execution — time the devices plausibly waited on.

Activation is process-local and explicit: ``activate(cfg, role=...)``
installs the module-level ``_ACTIVE`` profiler (engine and worker
processes call it post-fork from ``EngineConfig.profiling``); every
instrumented call site does ``profiling.active()`` and takes a branch-
free fast path when it is None — an uninstrumented run executes the
exact same statements it did before this module existed.

Copied from ``src/repro/profiling/__init__.py``, with its imports
rewritten to ``repro_torch``; the serving leaf's trace-only spans
(``LEAF_SITES``) and the model path's device-time spans (``MODEL_SITES``,
``ModelSpans``) are the port's own.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

# The injection-site catalogue: every name an injection spec may target.
# Sites are choke points, instrumented once where all callers converge:
#   scheduler    — Scheduler.schedule()          (engine core / DES engine)
#   tokenize     — TokenizerPool encode          (API server / DES pool)
#   detokenize   — TokenizerPool decode          (API server response path)
#   shm_encode   — StepPlan.encode serialization (engine core / DES)
#   shm_publish  — ShmBroadcastQueue enqueue     (engine core / DES)
#   copy_submit  — CopyEngine.submit             (scheduler, both modes)
#   block_alloc  — BlockManager.allocate         (scheduler, both modes)
#   dispatch     — worker plan decode + backend dispatch (worker / DES)
SITES = ("scheduler", "tokenize", "detokenize", "shm_encode",
         "shm_publish", "copy_submit", "block_alloc", "dispatch")

# Trace-only spans of the serving leaf (``backend.surrogate``), nested in
# the worker's trace-only ``device`` span: building a step's host-side
# inputs, copying them to the device, enqueueing the device work, and the
# blocking read of the sampled tokens.  Not injection sites; the
# summaries count them as part of the cover set they sit in.
LEAF_SITES = ("leaf_pack", "leaf_copy", "leaf_launch", "leaf_read")

ENV_INJECT = "REPRO_INJECT"
ENV_TRACE = "REPRO_TRACE"


def parse_inject(spec: str) -> Dict[str, float]:
    """``"site=delay_us,..."`` -> {site: delay_seconds}.

    ``*`` targets every catalogue site (later entries override, so
    ``"*=100,tokenize=0"`` bumps everything except the tokenizer).
    Unknown site names are rejected — a typo'd sweep that silently
    injects nothing would fit a zero slope and rank the site immaterial.
    """
    delays: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        # accept both "site=us" and the speed-bump exemplar's "site:us"
        sep = "=" if "=" in part else ":"
        site, _, val = part.partition(sep)
        site = site.strip()
        seconds = float(val.strip()) * 1e-6
        if seconds < 0:
            raise ValueError(f"negative injection delay: {part!r}")
        if site == "*":
            for s in SITES:
                delays[s] = seconds
        elif site in SITES:
            delays[site] = seconds
        else:
            raise ValueError(
                f"unknown injection site {site!r} (want one of {SITES} "
                f"or '*')")
    return delays


@dataclasses.dataclass(frozen=True)
class ProfilingConfig:
    """What to inject and whether to trace — inert by default.

    Rides ``EngineConfig`` into the forked engine/worker processes (and
    ``ServingParams.inject`` into the DES).  ``enabled`` is the single
    gate ``activate`` checks: an all-default config installs nothing, so
    the uninstrumented fast path stays the default everywhere."""
    inject: str = ""          # "site=delay_us,..." ("*" = every site)
    trace: bool = False       # collect span events for the timeline

    @classmethod
    def from_env(cls) -> "ProfilingConfig":
        return cls(inject=os.environ.get(ENV_INJECT, ""),
                   trace=bool(os.environ.get(ENV_TRACE, "")))

    @property
    def enabled(self) -> bool:
        return bool(self.inject) or self.trace


@dataclasses.dataclass
class SpanEvent:
    """One completed span (or instant, when ``dur == 0.0`` and
    ``instant``): ``t0`` is CLOCK_MONOTONIC seconds, comparable across
    processes on one machine.  ``phase`` is the step's scheduling phase
    (``StepPlan.phase``: prefill/decode/mixed/swap/dispatch) when the
    emitter knew it — ``phase_summary`` joins phase-less spans to it by
    step id."""
    site: str
    t0: float
    dur: float
    step: Optional[int] = None
    req: Optional[int] = None
    instant: bool = False
    phase: Optional[str] = None


class _Span:
    """Context manager recording one span and applying the site's
    injected delay INSIDE it — the module under measurement really gets
    slower, and the trace shows the bump where it was charged."""

    __slots__ = ("prof", "site", "step", "req", "phase", "t0")

    def __init__(self, prof: "Profiler", site: str,
                 step: Optional[int], req: Optional[int],
                 phase: Optional[str]):
        self.prof = prof
        self.site = site
        self.step = step
        self.req = req
        self.phase = phase

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        prof = self.prof
        d = prof.delays.get(self.site, 0.0)
        if d > 0.0:
            time.sleep(d)
            prof.charged += d
        if prof.trace:
            prof.events.append(SpanEvent(
                self.site, self.t0, time.perf_counter() - self.t0,
                self.step, self.req, phase=self.phase))


class Profiler:
    """Per-process injector + event collector (see module docstring).

    ``virtual=True`` (the DES) never sleeps and never timestamps:
    ``hit``/``charge`` accumulate ``pending`` seconds that the sim procs
    drain into ``("cpu", s)`` yields — the GPS core-sharing model, not
    the wall clock, prices the slowdown."""

    def __init__(self, cfg: ProfilingConfig, *, role: str = "main",
                 virtual: bool = False):
        self.cfg = cfg
        self.role = role
        self.virtual = virtual
        self.delays = parse_inject(cfg.inject)
        self.trace = cfg.trace and not virtual
        self.events: List[SpanEvent] = []
        self.pending = 0.0            # virtual mode: undrained seconds
        # lifetime injected seconds (both modes): the denominator of the
        # amplification slope — makespan seconds lost per second injected
        # (benchmarks/speed_bump.py); GPS contention makes it > 1 when
        # cores are scarce, which is the paper's thesis as a number
        self.charged = 0.0

    # -- wall mode -------------------------------------------------------

    def span(self, site: str, *, step: Optional[int] = None,
             req: Optional[int] = None,
             phase: Optional[str] = None) -> _Span:
        return _Span(self, site, step, req, phase)

    # -- both modes ------------------------------------------------------

    def hit(self, site: str, *, step: Optional[int] = None,
            req: Optional[int] = None, n: int = 1) -> None:
        """Charge ``n`` occurrences of ``site`` at a point (no span body
        to wrap — CopyEngine.submit, BlockManager.allocate).  Wall mode
        sleeps and records an instant event; virtual mode accrues
        ``pending``."""
        d = self.delays.get(site, 0.0) * n
        self.charged += d
        if self.virtual:
            self.pending += d
            return
        if self.trace:
            self.events.append(SpanEvent(site, time.perf_counter(), 0.0,
                                         step, req, instant=True))
        if d > 0.0:
            time.sleep(d)

    charge = hit

    def drain(self) -> float:
        """Take and reset the accumulated virtual delay.  Exactly 0.0
        when nothing was charged — callers skip their extra-cpu yield on
        that, which is what makes an idle profiler bit-exact."""
        out, self.pending = self.pending, 0.0
        return out


# -- process-local activation -------------------------------------------------

_ACTIVE: Optional[Profiler] = None


def active() -> Optional[Profiler]:
    """The installed profiler, or None (the uninstrumented fast path)."""
    return _ACTIVE


def activate(cfg: ProfilingConfig, *, role: str = "main",
             virtual: bool = False) -> Optional[Profiler]:
    """Install a profiler for this process when ``cfg`` asks for one
    (else install nothing and return None).  The env spec is merged in
    so ``REPRO_INJECT`` works even for entry points that never touch
    ``ProfilingConfig``."""
    global _ACTIVE
    env = ProfilingConfig.from_env()
    if env.enabled and not cfg.enabled:
        cfg = env
    if not cfg.enabled:
        _ACTIVE = None
        return None
    _ACTIVE = Profiler(cfg, role=role, virtual=virtual)
    return _ACTIVE


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def install(prof: Optional[Profiler]) -> Optional[Profiler]:
    """Swap the installed profiler, returning the previous one.  The DES
    uses this to scope its per-replica virtual profiler to exactly the
    scheduler calls it is charging (a FleetModel holds one profiler per
    replica, so the module-level slot is set around each call and
    restored after — safe because sim procs run single-threaded and the
    install/call/restore sequence contains no yields)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = prof
    return prev


def hit(site: str, *, step: Optional[int] = None,
        req: Optional[int] = None, n: int = 1) -> None:
    """Module-level point charge — the one-liner shared call sites use
    (``profiling.hit("block_alloc")``).  No-op when nothing is active."""
    p = _ACTIVE
    if p is not None:
        p.hit(site, step=step, req=req, n=n)


# -- merge + export ------------------------------------------------------------

def events_from_stats(stats: Iterable[dict],
                      extra: Optional[List[Tuple[str, List[SpanEvent]]]]
                      = None) -> List[Tuple[str, SpanEvent]]:
    """Collect (role, event) pairs from engine/worker stats dicts (each
    process ships its profiler's events under ``"trace_events"``) plus
    any in-process collections (the API-server profiler)."""
    out: List[Tuple[str, SpanEvent]] = []
    for s in stats:
        for ev in s.get("trace_events", ()):
            out.append((s["role"], ev))
    for role, evs in (extra or ()):
        for ev in evs:
            out.append((role, ev))
    out.sort(key=lambda p: p[1].t0)
    return out


def export_chrome_trace(pairs: List[Tuple[str, SpanEvent]],
                        path: str) -> int:
    """Write merged events as Chrome/Perfetto ``trace_event`` JSON
    (load in ``chrome://tracing`` or https://ui.perfetto.dev).  One tid
    per role; ts/dur in microseconds, rebased to the earliest event."""
    t_base = pairs[0][1].t0 if pairs else 0.0
    roles = sorted({role for role, _ in pairs})
    tid = {role: i for i, role in enumerate(roles)}
    events = []
    for role, ev in pairs:
        args = {}
        if ev.step is not None:
            args["step"] = ev.step
        if ev.req is not None:
            args["req"] = ev.req
        if ev.phase is not None:
            args["phase"] = ev.phase
        rec = {"name": ev.site, "cat": "control-plane",
               "pid": 0, "tid": tid[role],
               "ts": (ev.t0 - t_base) * 1e6, "args": args}
        if ev.instant:
            rec.update(ph="i", s="t")
        else:
            rec.update(ph="X", dur=ev.dur * 1e6)
        events.append(rec)
    meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": t,
             "args": {"name": role}} for role, t in tid.items()]
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + events,
                   "displayTimeUnit": "ms"}, f)
    return len(events)


def _merge_intervals(ivs: List[Tuple[float, float]]
                     ) -> List[Tuple[float, float]]:
    ivs = sorted(ivs)
    out: List[Tuple[float, float]] = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _overlap(a0: float, a1: float,
             merged: List[Tuple[float, float]]) -> float:
    """Seconds of [a0, a1] covered by the merged interval set."""
    covered = 0.0
    for b0, b1 in merged:
        if b1 <= a0:
            continue
        if b0 >= a1:
            break
        covered += min(a1, b1) - max(a0, b0)
    return covered


def critical_path_summary(pairs: List[Tuple[str, SpanEvent]],
                          device_site: str = "device") -> Dict[str, dict]:
    """Per-site totals + the share NOT hidden behind device execution.

    ``device`` spans (the workers' ``backend.execute`` windows), with
    the ``LEAF_SITES`` spans nested in them, are the cover set and get
    no row of their own: control-plane time that overlaps a device span
    ran while the accelerators were busy anyway; the *exposed* remainder
    is time the devices plausibly waited on — the trace-side estimate the
    injection sweep's sensitivity slope confirms or refutes per site
    ("time spent ≠ time that matters" runs both ways: exposed-but-
    insensitive spans are slack, hidden-but-sensitive ones are the
    pipeline's hidden serialization)."""
    cover = (device_site,) + LEAF_SITES
    device = _merge_intervals([(ev.t0, ev.t0 + ev.dur)
                               for _, ev in pairs
                               if ev.site in cover and not ev.instant])
    summary: Dict[str, dict] = {}
    for _, ev in pairs:
        if ev.site in cover:
            continue
        s = summary.setdefault(ev.site, {"count": 0, "total_s": 0.0,
                                         "exposed_s": 0.0})
        s["count"] += 1
        if ev.instant:
            continue
        s["total_s"] += ev.dur
        # clamp: a fully-covered span's dur-minus-overlap can come out a
        # few ulp negative, and exposed time is non-negative by definition
        s["exposed_s"] += max(0.0, ev.dur - _overlap(ev.t0, ev.t0 + ev.dur,
                                                     device))
    return summary


def phase_summary(pairs: List[Tuple[str, SpanEvent]],
                  device_site: str = "device") -> Dict[str, dict]:
    """Flamegraph-style rollup of exposed control-plane time by STEP
    PHASE (``StepPlan.phase``: prefill / decode / mixed / swap /
    dispatch), with a per-site breakdown inside each phase.

    ``critical_path_summary`` answers "which module exposes time"; this
    answers "during which kind of step" — the paper's per-phase view
    (prefill steps tolerate control-plane cost, decode steps amortize
    nothing).  Spans that don't carry a phase themselves (the engine's
    scheduler/broadcast spans) join to one through their step id, using
    the phase the workers' spans recorded for that step; spans with
    neither land in ``"unattributed"``."""
    phase_of: Dict[int, str] = {}
    for _, ev in pairs:
        if ev.phase is not None and ev.step is not None:
            phase_of.setdefault(ev.step, ev.phase)
    cover = (device_site,) + LEAF_SITES
    device = _merge_intervals([(ev.t0, ev.t0 + ev.dur)
                               for _, ev in pairs
                               if ev.site in cover and not ev.instant])
    out: Dict[str, dict] = {}
    for _, ev in pairs:
        if ev.site in cover or ev.instant:
            continue
        phase = ev.phase
        if phase is None and ev.step is not None:
            phase = phase_of.get(ev.step)
        if phase is None:
            phase = "unattributed"
        p = out.setdefault(phase, {"count": 0, "total_s": 0.0,
                                   "exposed_s": 0.0, "sites": {}})
        exposed = max(0.0, ev.dur - _overlap(ev.t0, ev.t0 + ev.dur,
                                             device))
        p["count"] += 1
        p["total_s"] += ev.dur
        p["exposed_s"] += exposed
        s = p["sites"].setdefault(ev.site, {"count": 0, "total_s": 0.0,
                                            "exposed_s": 0.0})
        s["count"] += 1
        s["total_s"] += ev.dur
        s["exposed_s"] += exposed
    return out


def format_phase_summary(summary: Dict[str, dict]) -> str:
    """Indented text flamegraph: one row per phase, site rows under it,
    both ordered by exposed time."""
    lines = [f"{'phase / site':<22} {'count':>7} {'total_ms':>10} "
             f"{'exposed_ms':>11}"]
    for phase, p in sorted(summary.items(),
                           key=lambda kv: -kv[1]["exposed_s"]):
        lines.append(f"{phase:<22} {p['count']:>7} "
                     f"{p['total_s'] * 1e3:>10.2f} "
                     f"{p['exposed_s'] * 1e3:>11.2f}")
        for site, s in sorted(p["sites"].items(),
                              key=lambda kv: -kv[1]["exposed_s"]):
            lines.append(f"  {site:<20} {s['count']:>7} "
                         f"{s['total_s'] * 1e3:>10.2f} "
                         f"{s['exposed_s'] * 1e3:>11.2f}")
    return "\n".join(lines)


def format_summary(summary: Dict[str, dict]) -> str:
    lines = [f"{'site':<12} {'count':>7} {'total_ms':>10} "
             f"{'exposed_ms':>11} {'exposed%':>9}"]
    for site, s in sorted(summary.items(),
                          key=lambda kv: -kv[1]["exposed_s"]):
        pct = (100.0 * s["exposed_s"] / s["total_s"]
               if s["total_s"] > 0 else 0.0)
        lines.append(f"{site:<12} {s['count']:>7} "
                     f"{s['total_s'] * 1e3:>10.2f} "
                     f"{s['exposed_s'] * 1e3:>11.2f} {pct:>8.1f}%")
    return "\n".join(lines)


# -- the model path's device time (port-only) ----------------------------------

# Device-time spans of a prefill's layers (``models.model.HybridMoELayer.
# full`` and ``AttnLayer.full``, eager calls only: a captured graph's
# replays run no Python): a hybrid layer's mixer, by kind, a latent
# attention layer's attention (``mla_mixer``), and each layer's
# feed-forward (the MLP, or the experts and the shared experts).
MODEL_SITES = ("ssm_mixer", "attn_mixer", "ffn", "mla_mixer")

_UNTIMED = contextlib.nullcontext()


class ModelSpans:
    """The model path's spans, process-local and off by default: the sites
    call ``model_span``, which returns a shared no-op context unless
    ``start_model_spans`` installed one of these.  On the card a span
    records a pair of CUDA events on the current stream around its work,
    and ``totals`` waits for them; elsewhere it reads the host's clock
    (work on the CPU is done when its call returns)."""

    def __init__(self):
        self.pending: List[Tuple[str, object, object]] = []
        self.host_ms: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, site: str, device):
        self.counts[site] = self.counts.get(site, 0) + 1
        if device.type == "cuda":
            import torch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.pending.append((site, start, end))
            return
        t0 = time.perf_counter()
        yield
        self.host_ms[site] = (self.host_ms.get(site, 0.0)
                              + (time.perf_counter() - t0) * 1e3)

    def totals(self) -> Dict[str, float]:
        """Each site's milliseconds so far, summed over its spans."""
        out = dict(self.host_ms)
        for site, start, end in self.pending:
            end.synchronize()
            out[site] = out.get(site, 0.0) + start.elapsed_time(end)
        return out


_MODEL: Optional[ModelSpans] = None


def model_span(site: str, device):
    """The span of ``site`` on ``device`` when the model's spans are on,
    else the shared no-op context."""
    spans = _MODEL
    if spans is None:
        return _UNTIMED
    return spans.span(site, device)


def start_model_spans() -> ModelSpans:
    """Turn the model path's spans on in this process."""
    global _MODEL
    _MODEL = ModelSpans()
    return _MODEL


def stop_model_spans() -> Optional[ModelSpans]:
    """Turn them off; returns what they recorded."""
    global _MODEL
    spans, _MODEL = _MODEL, None
    return spans
