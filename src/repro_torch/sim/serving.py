"""Serving-pipeline model on the DES core — the core-count sweep instrument.

Runs the REAL ``repro_torch.serving.Scheduler`` (same control logic as the live
engine) with simulated costs, so core-count sweeps (5..64 cores, more than a
small host has) reproduce the paper's Figs 5/7/8/9/10/13.

Per step (sync engine, mirroring core.engine):
  engine: schedule [cpu] -> broadcast [cpu] -> SPIN on completion  (shm poll)
  worker i: SPIN on message (shm dequeue) -> dispatch [cpu]
            -> barrier (all ranks dispatched) -> device [sleep] -> mark
  tokenizer pool: ``pool_width`` procs, each tokenize = n_tokens/tok_rate CPU.

Spinning procs consume CPU in the GPS model — precisely the §V-B contention:
idle-but-polling workers steal cycles from the tokenizer and vice versa.

Copied from ``src/repro/sim/serving.py``, with its imports rewritten to
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Dict, List, Optional, Tuple

from repro_torch import profiling
from repro_torch.backend.emulated import EmulatedBackend
from repro_torch.core.devmodel import DeviceModel
from repro_torch.profiling import Profiler, ProfilingConfig
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig, StepPlan
from repro_torch.sim.core import Event, Sim
from repro_torch.slo import (BATCH, INTERACTIVE, SLOClass, SLOMix,
                             parse_slo_mix, slo_summary, tag_request)


@dataclasses.dataclass(frozen=True)
class ServingParams:
    n_cores: int = 8
    tp: int = 4                      # worker count (tensor parallel degree)
    # Tokenizer thread count.  Rayon (HF tokenizers) sizes its pool to the
    # MACHINE's core count, not the cgroup allocation — so under concurrent
    # requests the runnable-thread count dwarfs the core budget, and every
    # engine/worker wake-up pays a multi-quantum scheduling delay.  This is
    # the paper's §IV-B mechanism ("Rayon thread pool ... faces less
    # contention" with more cores).
    pool_width: int = 64
    quantum: float = 3e-3            # CFS-scale scheduling granularity
    # calibrated host costs (seconds) — see sim/calibrate.py
    tok_rate: float = 200_000.0      # tokens/s per core (HF-Rust-class)
    sched_cost_base: float = 120e-6
    sched_cost_per_seq: float = 6e-6
    enqueue_cost: float = 15e-6
    # serializing the plan (block tables + input ids) is per-byte CPU work
    # — the broadcast cost now scales with batch size (paper §V-B)
    serialize_cost_per_byte: float = 1.5e-9
    dequeue_cost: float = 10e-6      # work after the spin
    dispatch_cost: float = 60e-6     # per-step kernel-launch batch
    device: DeviceModel = DeviceModel()
    scheduler: SchedulerConfig = SchedulerConfig()
    timeout: float = 200.0           # the paper's victim timeout
    # Fused multi-step decode (models.decode_multi): a decode-only plan
    # executes k tokens per broadcast/dispatch/barrier round trip.
    decode_fusion: int = 1
    # Split-phase execution (repro_torch.backend.hybrid, docs/backends.md):
    # when set, decode runs on an EmulatedBackend with THIS device model
    # (CPU tier — typically ``device.cpu_tier(...)``) while prefill keeps
    # ``device``; a step then costs max(prefill, decode) + the
    # prefill->decode page handoff at ``t_handoff_block`` per block
    # (defaults to the prefill device's swap bandwidth when <= 0).
    decode_device: Optional[DeviceModel] = None
    t_handoff_block: float = 0.0
    # Speculative decode (docs/spec_decode.md): active when
    # ``scheduler.speculative_k > 0``.  The draft runs on this device
    # model (typically ``device.cpu_tier(...)`` — the idle-CPU tier);
    # ``spec_accept_rate`` is the modeled fraction of drafts the verify
    # step accepts, the crossover knob benchmarks/spec_decode.py sweeps.
    draft_device: Optional[DeviceModel] = None
    spec_accept_rate: float = 0.8
    # Speed-bump slowdown injection (docs/profiling.md): "site=delay_us"
    # spec, same grammar as `serve --inject`.  The injected delays charge
    # as extra ("cpu", s) work in the GPS model — deterministic, priced
    # under the exact core budget being swept.  "" = no profiler at all;
    # a spec whose delays are all 0 is bit-exact with "" (the oracle).
    inject: str = ""
    # SLO latency classes (repro_torch.slo, docs/slo.md): an
    # "interactive:0.3,batch:0.7" spec makes ``add_request``/``inject_now``
    # tag otherwise-untagged requests in exact mix proportions
    # (deterministic largest-remainder, no RNG).  "" = no tagging.
    # Class-aware scheduling BEHAVIOR is a separate knob
    # (``scheduler.slo_aware``), so a class-blind baseline can serve the
    # same tagged workload.
    slo_mix: str = ""


def _dedup_by_rid(reqs: List[Request]) -> List[Request]:
    """One record per request id, arrival order preserved.

    A fleet-level retry re-dispatches a timed-out request to a second
    replica under the SAME id, so an aggregated result can hold two
    records for one logical request.  The completed record (first token
    produced) wins; otherwise the first record stands — one logical
    request contributes exactly one timeout, never one per replica that
    touched it."""
    best: Dict[int, Request] = {}
    order: List[int] = []
    for r in reqs:
        cur = best.get(r.req_id)
        if cur is None:
            best[r.req_id] = r
            order.append(r.req_id)
        elif r.t_first_token and not cur.t_first_token:
            best[r.req_id] = r
    return [best[k] for k in order]


@dataclasses.dataclass
class WorkloadResult:
    requests: List[Request]
    dequeue_waits: List[float]       # per worker-step spin seconds
    barrier_waits: List[float]       # engine completion-poll seconds
    sched_costs: int
    sim_time: float
    saturation_s: float

    def unique_requests(self) -> List[Request]:
        """Requests de-duplicated by id (see ``_dedup_by_rid``) — the only
        valid population for fleet-aggregated latency/timeout metrics."""
        return _dedup_by_rid(self.requests)

    def victims(self) -> List[Request]:
        return [r for r in self.unique_requests() if r.is_victim]

    def victim_ttfts(self) -> List[Optional[float]]:
        out = []
        for r in self.victims():
            out.append(r.ttft if r.t_first_token else None)   # None = timeout
        return out

    def slo_summary(self) -> Dict[str, dict]:
        """Per-class SLO attainment over the deduplicated requests
        (repro_torch.slo.slo_summary; empty when nothing is tagged)."""
        return slo_summary(self.unique_requests())


class ServingModel:
    def __init__(self, params: ServingParams):
        self.p = params
        self.sim = Sim(params.n_cores, quantum=params.quantum)
        self.sched = Scheduler(params.scheduler)
        # virtual-time device: the backend's cost model, never its sleep
        if params.decode_device is not None:
            from repro_torch.backend.hybrid import HybridBackend
            self.backend = HybridBackend(
                EmulatedBackend(params.device, sleep=False),
                EmulatedBackend(params.decode_device, sleep=False),
                t_handoff_block=(params.t_handoff_block
                                 if params.t_handoff_block > 0
                                 else params.device.t_swap_block),
                copy_streams=params.device.copy_streams,
                t_submit_per_copy=params.device.t_submit_per_copy)
        else:
            self.backend = EmulatedBackend(params.device, sleep=False)
        if params.scheduler.speculative_k > 0:
            # draft on the CPU tier, verify on whatever the target is —
            # step_cost serializes the two, synthesize_result models the
            # acceptance rate for complete_step
            from repro_torch.spec import SpeculativeBackend
            draft_dev = (params.draft_device
                         if params.draft_device is not None
                         else params.device.cpu_tier())
            self.backend = SpeculativeBackend(
                EmulatedBackend(draft_dev, sleep=False), self.backend,
                accept_rate=params.spec_accept_rate)
        # virtual-mode speed-bump profiler (docs/profiling.md): one per
        # replica, delays accrue in prof.pending and the procs drain them
        # as extra cpu work via _charge below
        self.prof: Optional[Profiler] = (
            Profiler(ProfilingConfig(inject=params.inject),
                     role="sim", virtual=True)
            if params.inject else None)
        # deterministic class assigner for untagged adds (docs/slo.md)
        self._slo_mix: Optional[SLOMix] = (
            SLOMix(parse_slo_mix(params.slo_mix))
            if params.slo_mix else None)
        self.requests: List[Request] = []
        self.tok_queue: List[Request] = []
        self.tok_ev = self.sim.event("tok-queue")
        self.engine_ev = self.sim.event("engine-input")
        # step events are keyed by plan ORDINAL (1st, 2nd, ... broadcast),
        # not plan.step_id: a multi-step macro-plan advances step_id by k
        # while remaining ONE broadcast/barrier round trip
        self.msg_ev: Dict[int, Event] = {}        # ordinal -> msg published
        self.dispatched: Dict[int, int] = {}      # ordinal -> ranks dispatched
        self._plans: Dict[int, StepPlan] = {}     # ordinal -> plan
        self.all_disp_ev: Dict[int, Event] = {}
        self.done_ev: Dict[int, Event] = {}
        self.dequeue_waits: List[float] = []
        self.barrier_waits: List[float] = []
        self.done_events: Dict[int, Event] = {}   # req_id -> completion event
        self.extra_procs: List = []
        self.n_steps = 0
        self._stopped = False

    # -- request injection -------------------------------------------------------

    def _assign_slo(self, req: Request, slo: Optional[SLOClass]) -> None:
        """Tag ``req``: an explicit class wins, else draw from the
        params-level mix (deterministic in creation order), else untagged."""
        if slo is None and self._slo_mix is not None:
            slo = self._slo_mix.next()
        tag_request(req, slo)

    def add_request(self, t_arrival: float, n_tokens: int,
                    max_new_tokens: int = 8, is_victim: bool = False,
                    stream: int = 0,
                    slo: Optional[SLOClass] = None) -> Request:
        """``stream`` namespaces the token ids: requests in different streams
        share no prefix (attackers with identical prompts DO share one and
        get vLLM-style prefix-cache hits)."""
        req = Request(text="", max_new_tokens=max_new_tokens,
                      is_victim=is_victim)
        self._assign_slo(req, slo)
        base = stream << 24
        req.prompt_tokens = list(range(base, base + n_tokens))
        req.t_arrival = t_arrival
        self.requests.append(req)

        def arrive():
            self.tok_queue.append(req)
            ev, self.tok_ev = self.tok_ev, self.sim.event("tok-queue")
            self.sim.fire(ev)

        self.sim.at(t_arrival, arrive)
        return req

    def inject_now(self, n_tokens: int, max_new_tokens: int = 8,
                   is_victim: bool = False, stream: int = 0,
                   slo: Optional[SLOClass] = None) -> Request:
        """Add a request at the current sim time (for issuer procs)."""
        req = Request(text="", max_new_tokens=max_new_tokens,
                      is_victim=is_victim)
        self._assign_slo(req, slo)
        base = stream << 24
        req.prompt_tokens = list(range(base, base + n_tokens))
        return self.inject_request(req)

    def inject_request(self, req: Request) -> Request:
        """Inject a pre-built request at the current sim time (the fleet
        router dispatches — and on retry re-dispatches a same-id clone —
        through this)."""
        req.t_arrival = self.sim.now
        self.requests.append(req)
        self.tok_queue.append(req)
        ev, self.tok_ev = self.tok_ev, self.sim.event("tok-queue")
        self.sim.fire(ev)
        return req

    # -- procs -------------------------------------------------------------------

    def _charge(self, fn=None, *, sites=()):
        """Run ``fn`` with this replica's virtual profiler installed (so
        block_alloc/copy_submit hits inside the scheduler land on it),
        charge the named ``sites`` once each, and return
        ``(result, extra_cpu_seconds)``.  The caller yields
        ``("cpu", extra)`` only when extra > 0 — with no profiler, or all
        delays 0, the proc's event sequence is bit-exact with an
        uninjected run."""
        prof = self.prof
        if prof is None:
            return (fn() if fn is not None else None), 0.0
        prev = profiling.install(prof)
        try:
            out = fn() if fn is not None else None
        finally:
            profiling.install(prev)
        for s in sites:
            prof.hit(s)
        return out, prof.drain()

    def _tokenizer_dispatcher(self):
        """Models the Rayon pool: each encode fans out over ``pool_width``
        worker shards (HF tokenizers parallelize word-level within one
        text), so ANY active tokenization makes the whole pool runnable —
        the §IV-B contention mechanism."""
        p = self.p
        while not self._stopped:
            if not self.tok_queue:
                yield ("wait", self.tok_ev)
                continue
            req = self.tok_queue.pop(0)
            req.t_tokenize_start = self.sim.now
            shards = max(1, p.pool_width)
            work = req.n_prompt / p.tok_rate / shards
            done = {"n": 0}
            join_ev = self.sim.event(f"tok-join-{req.req_id}")

            def shard_proc(work=work, done=done, join_ev=join_ev,
                           shards=shards):
                yield ("cpu", work)
                done["n"] += 1
                if done["n"] == shards:
                    self.sim.fire(join_ev)

            for s in range(shards):
                self.sim.spawn(f"tokshard", shard_proc())
            yield ("wait", join_ev)
            _, extra = self._charge(sites=("tokenize",))
            if extra > 0.0:
                yield ("cpu", extra)
            req.t_tokenize_done = self.sim.now
            self.sched.add_request(req)
            ev, self.engine_ev = self.engine_ev, self.sim.event("engine-input")
            self.sim.fire(ev)

    def _get_step_events(self, step: int) -> Tuple[Event, Event]:
        """(msg published, step done) events, created lazily by either side."""
        if step not in self.msg_ev:
            self.msg_ev[step] = self.sim.event(f"msg{step}")
            self.done_ev[step] = self.sim.event(f"done{step}")
            self.dispatched[step] = 0
        return self.msg_ev[step], self.done_ev[step]

    def _engine_proc(self):
        p = self.p
        while not self._stopped:
            plan = None
            if self.sched.has_work:
                expired, extra0 = self._charge(
                    lambda: self.sched.expire(self.sim.now, p.timeout))
                for req in expired:
                    ev = self.done_events.get(req.req_id)
                    if ev is not None:
                        self.sim.fire(ev)
                # cost + 0.0 == cost exactly, so the uninjected cost
                # expression is bit-identical when nothing was charged
                yield ("cpu", p.sched_cost_base
                       + p.sched_cost_per_seq * len(self.sched.running)
                       + extra0)
                plan, extra = self._charge(self.sched.schedule,
                                           sites=("scheduler",))
                if extra > 0.0:
                    yield ("cpu", extra)
            if plan is None:
                yield ("wait", self.engine_ev)
                continue
            self.n_steps += 1
            self._plans[self.n_steps] = plan
            msg, done = self._get_step_events(self.n_steps)
            _, extra = self._charge(sites=("shm_encode", "shm_publish"))
            yield ("cpu", p.enqueue_cost
                   + plan.approx_payload_bytes() * p.serialize_cost_per_byte
                   + extra)
            self.sim.fire(msg)
            # completion poll: busy-wait on the board (paper §V-B)
            t0 = self.sim.now
            yield ("spin", done)
            self.barrier_waits.append(self.sim.now - t0)
            # speculative plans complete with a synthesized acceptance-
            # rate result (repro_torch.spec); everything else keeps the
            # full-budget default (result=None)
            synth = getattr(self.backend, "synthesize_result", None)
            res = synth(plan) if synth is not None else None
            extra_done = 0.0
            for _ in range(self._fusion_rounds(plan)):
                completed, extra = self._charge(
                    lambda: self.sched.complete_step(plan, self.sim.now,
                                                     res))
                extra_done += extra
                for req in completed:
                    ev = self.done_events.get(req.req_id)
                    if ev is not None:
                        self.sim.fire(ev)
            if extra_done > 0.0:
                # block allocations during token append (and copy-engine
                # retires) charged inside complete_step
                yield ("cpu", extra_done)

    def _fusion_rounds(self, plan: Optional[StepPlan]) -> int:
        """Decode-only plans run ``decode_fusion`` tokens per dispatch
        (models.decode_multi — the persistent-kernel analogue).  A
        scheduler-emitted macro-plan already multi-steps with full KV
        accounting (docs/multi_step.md), so the legacy knob must not
        double-count it: one completion round, the plan itself carries
        ``num_steps``."""
        if plan is None or plan.num_steps > 1:
            return 1
        if self.p.decode_fusion <= 1 or plan.prefill:
            return 1
        return self.p.decode_fusion

    def _worker_proc(self, rank: int):
        p = self.p
        step = 1        # plan ordinal: one iteration per broadcast, even
                        # when a macro-plan spans k scheduler step ids
        while not self._stopped:
            msg, done = self._get_step_events(step)
            t0 = self.sim.now
            yield ("spin", msg)                     # shm dequeue busy-wait
            self.dequeue_waits.append(self.sim.now - t0)
            _, extra = self._charge(sites=("dispatch",))
            yield ("cpu", p.dequeue_cost + p.dispatch_cost + extra)
            self.dispatched[step] += 1
            if self.dispatched[step] == p.tp:       # last rank arms device
                plan_t = self._plan_time(step)
                self.sim.at(self.sim.now + plan_t,
                            lambda d=done: self.sim.fire(d))
            yield ("wait", done)                    # sync execute
            step += 1

    def _plan_time(self, step: int) -> float:
        plan = self._plans.get(step)
        if plan is None:
            return 1e-3
        return self.backend.step_cost(plan) * self._fusion_rounds(plan)

    # -- run ---------------------------------------------------------------------
    # run() = start() + advance(horizon) + finalize().  The split exists for
    # FleetModel, which advances N replicas in lockstep time slices to each
    # routing decision point; Sim.run is pause-exact (repro_torch.sim.core), so a
    # sliced advance produces the same trajectory an uninterrupted run would.

    def start(self) -> "ServingModel":
        """Spawn the pipeline procs (idempotent)."""
        if getattr(self, "_procs_started", False):
            return self
        self._procs_started = True
        # Rayon pool: requests are serviced one at a time (GIL holds the
        # Python side), each fanning out across the whole thread pool.
        self.sim.spawn("tok-dispatch", self._tokenizer_dispatcher())
        self.sim.spawn("engine", self._engine_proc())
        for r in range(self.p.tp):
            self.sim.spawn(f"worker{r}", self._worker_proc(r))
        for i, gen in enumerate(self.extra_procs):
            self.sim.spawn(f"extra{i}", gen)
        return self

    def advance(self, until: float) -> None:
        """Advance the replica's private clock to ``until``."""
        self.start()
        self.sim.run(until=until)

    def finalize(self) -> WorkloadResult:
        # mark timeouts (including ones the engine never got to expire);
        # a request's own timeout (from its SLO class) overrides the global
        for req in self.requests:
            if not req.t_first_token:
                limit = (req.timeout if req.timeout is not None
                         else self.p.timeout)
                ttft_so_far = self.sim.now - req.t_arrival
                if ttft_so_far >= limit - 1e-9:
                    req.state = RequestState.TIMED_OUT
        return WorkloadResult(
            requests=self.requests,
            dequeue_waits=self.dequeue_waits,
            barrier_waits=self.barrier_waits,
            sched_costs=self.n_steps,
            sim_time=self.sim.now,
            saturation_s=self.sim.saturation_seconds(),
        )

    def run(self, horizon: float = 400.0) -> WorkloadResult:
        self.advance(horizon)
        return self.finalize()


def victim_stats(res: WorkloadResult, timeout: float) -> dict:
    """Victim-latency summary shared by the attacker/victim benchmarks
    (fig7 and preemption_policy must aggregate identically)."""
    tt = res.victim_ttfts()
    done = [t for t in tt if t is not None and t < timeout]
    out = {
        "victim_ttfts": [round(t, 2) if t is not None else None for t in tt],
        "first_victim_ttft": round(tt[0], 2) if tt and tt[0] else None,
        "mean_completed_ttft": (round(sum(done) / len(done), 2)
                                if done else None),
        # the victim-selection knob's target metric: the worst completed
        # victim (the tail queues behind every mispriced eviction)
        "max_completed_ttft": round(max(done), 2) if done else None,
        "timeouts": sum(1 for t in tt if t is None or t >= timeout),
    }
    # timeout split per SLO class (docs/slo.md) — present only when the
    # workload tagged requests, so class-blind runs are unchanged
    by_class: Dict[str, int] = {}
    for r in res.unique_requests():
        if r.slo is not None and r.state is RequestState.TIMED_OUT:
            by_class[r.slo.name] = by_class.get(r.slo.name, 0) + 1
    if by_class:
        out["timeouts_by_class"] = by_class
    return out


@dataclasses.dataclass
class FleetResult(WorkloadResult):
    """Fleet-aggregated WorkloadResult: same metrics over the union of the
    replicas' requests (``unique_requests`` de-duplicates retried ids),
    plus the per-replica results and router counters."""
    per_replica: List[WorkloadResult] = dataclasses.field(
        default_factory=list)
    router: Dict[str, object] = dataclasses.field(default_factory=dict)


def merge_results(results: List[WorkloadResult],
                  router: Optional[Dict[str, object]] = None) -> FleetResult:
    """Aggregate per-replica results into one fleet view.  ``sim_time`` is
    the shared clock (max); ``saturation_s`` sums CPU-saturated seconds
    across replicas (each has a private core pool)."""
    return FleetResult(
        requests=[r for res in results for r in res.requests],
        dequeue_waits=[w for res in results for w in res.dequeue_waits],
        barrier_waits=[w for res in results for w in res.barrier_waits],
        sched_costs=sum(res.sched_costs for res in results),
        sim_time=max((res.sim_time for res in results), default=0.0),
        saturation_s=sum(res.saturation_s for res in results),
        per_replica=list(results),
        router=dict(router or {}),
    )


_TERMINAL = (RequestState.FINISHED, RequestState.TIMED_OUT)


class FleetModel:
    """N ``ServingModel`` replicas behind a ``repro_torch.fleet.FleetRouter``,
    advanced in lockstep on a shared fleet clock.

    Each replica keeps its PRIVATE ``Sim`` (its own core pool — fleet
    replicas do not share CPUs), and the fleet loop advances every replica
    to each routing decision point: open-loop arrival times
    (``add_request``), closed-loop session turns (``add_session``), and a
    ``route_quantum`` polling tick while sessions or retries are in
    flight.  ``Sim.run`` is pause-exact, so slicing a replica's timeline
    at fleet boundaries reproduces the trajectory an uninterrupted run
    would have taken; under ``round-robin`` with no sessions/retries the
    loop additionally advances ONLY the target replica per arrival, which
    makes each replica's event arithmetic bit-identical to an
    independently fed ``ServingModel`` (pinned by
    tests/test_fleet_conformance.py).

    Routing itself costs zero simulated time — the router's real CPU cost
    belongs to the live frontend, not the replica control planes under
    study.  Router decisions read authoritative
    ``Scheduler.pressure_stats`` snapshots (with bloom prefix summaries)
    plus instantaneous DES CPU saturation (runnable/cores).

    ``max_retries > 0`` re-dispatches a timed-out request to another
    replica under the SAME request id — the aggregation-side dedup
    (``WorkloadResult.unique_requests``) is what keeps such a request
    from counting as one timeout per replica it visited.
    """

    def __init__(self, params: ServingParams, n_replicas: int = 2,
                 routing: str = "affinity", route_quantum: float = 0.25,
                 max_retries: int = 0, router_cfg=None,
                 autoscaler=None, autoscale_quantum: float = 5.0):
        from repro_torch.fleet.router import FleetRouter, RouterConfig
        self.p = params
        self.n = n_replicas
        self.replicas = [ServingModel(params) for _ in range(n_replicas)]
        if router_cfg is None:
            router_cfg = RouterConfig(
                policy=routing, block_size=params.scheduler.block_size)
        elif router_cfg.policy != routing:
            router_cfg = dataclasses.replace(router_cfg, policy=routing)
        self.router = FleetRouter(
            n_replicas, router_cfg,
            stats_fns=[self._stats_fn(i) for i in range(n_replicas)])
        self.route_quantum = route_quantum
        self.max_retries = max_retries
        # fleet-level SLO mix: classes are drawn at DISPATCH (routing
        # order) so the spec always carries one and the replicas' own
        # params-level mixes never double-draw
        self._slo_mix: Optional[SLOMix] = (
            SLOMix(parse_slo_mix(params.slo_mix))
            if params.slo_mix else None)
        # closed-loop autoscaling (repro_torch.fleet.autoscale): when an
        # autoscaler is attached, every ``autoscale_quantum`` of fleet
        # time the loop differences pressure snapshots into
        # ReplicaSignals, feeds observe(), and ACTS on the
        # recommendation — scale-up spawns a fresh replica mid-run,
        # scale-down drains the newest active one (in-flight work
        # finishes in place; the drain path is the same one
        # drain_replica_at uses).  scale_log records every action.
        self.autoscaler = autoscaler
        self.autoscale_quantum = autoscale_quantum
        self._active: List[int] = list(range(n_replicas))
        self._as_prev: Dict[int, object] = {}    # idx -> last PressureStats
        self._as_prev_resolved: Dict[int, int] = {}
        self._next_scale = autoscale_quantum
        self.scale_log: List[Tuple[float, str, int, str]] = []
        self._arrivals: List[Tuple[float, int, dict]] = []   # heap
        self._seq = itertools.count()
        self._sessions: List[dict] = []
        # [req, replica idx, retries left, books closed] per dispatch —
        # "closed" guards the rid's router record: a retried request's
        # clone reuses the id, so the original record must be released
        # exactly once and never after the clone is outstanding
        self._dispatched: List[list] = []
        # scheduled replica drains: (fleet time, replica idx) heap, and a
        # log of (t, idx, orphaned rids) for each executed drain
        self._drains: List[Tuple[float, int]] = []
        self.drain_log: List[Tuple[float, int, List[int]]] = []
        self.n_retries = 0
        self._now = 0.0

    def _stats_fn(self, i: int):
        # windowed mean utilization since the previous stats call, read
        # from the sim's piecewise-constant util_trace (the same trace
        # Sim.saturation_seconds integrates).  An instantaneous
        # runnable/cores sample is too noisy for hysteresis: it flaps
        # between 0 and 1 depending on which event boundary the route
        # decision lands on, and every flap breaks affinity stickiness.
        state = {"t": 0.0, "k": 0}
        def fn():
            m = self.replicas[i]
            tr = m.sim.util_trace
            now, t0, k = m.sim.now, state["t"], state["k"]
            busy = 0.0
            while k + 1 < len(tr):
                (ta, u), tb = tr[k], tr[k + 1][0]
                lo = max(ta, t0)
                if tb > lo:
                    busy += (tb - lo) * u
                k += 1
            if tr:     # tail segment: last recorded frac holds until now
                ta, u = tr[-1]
                lo = max(ta, t0)
                if now > lo:
                    busy += (now - lo) * u
            sat = busy / (now - t0) if now > t0 else \
                (tr[-1][1] if tr else 0.0)
            state["t"], state["k"] = now, max(0, len(tr) - 1)
            m.sched.note_cpu_saturation(sat)
            return m.sched.pressure_stats(with_prefix_summary=True)
        return fn

    # -- workload construction ----------------------------------------------

    def add_request(self, t_arrival: float, n_tokens: int,
                    max_new_tokens: int = 8, is_victim: bool = False,
                    stream: int = 0, session=None,
                    slo: Optional[SLOClass] = None) -> None:
        """Open-loop arrival, routed at ``t_arrival`` on the fleet clock."""
        heapq.heappush(self._arrivals, (t_arrival, next(self._seq), dict(
            n_tokens=n_tokens, max_new_tokens=max_new_tokens,
            is_victim=is_victim, stream=stream, session=session, slo=slo)))

    def add_session(self, t_start: float, n_requests: int, n_tokens: int,
                    max_new_tokens: int = 8, think: float = 0.5,
                    stream: Optional[int] = None, is_victim: bool = False,
                    grow_tokens: int = 0) -> int:
        """Closed-loop session: ``n_requests`` turns, each issued ``think``
        seconds after the previous turn completes (or times out).  All
        turns share the session's token stream, so turn j's prompt is an
        exact prefix-cache hit for turn j+1 (plus ``grow_tokens`` fresh
        tokens per turn) — the prefix-heavy workload affinity routing is
        for."""
        sid = len(self._sessions)
        self._sessions.append({
            "key": f"session-{sid}",
            "stream": stream if stream is not None else 4096 + sid,
            "n_left": n_requests, "n_sent": 0, "next_t": t_start,
            "think": think, "n_tokens": n_tokens,
            "max_new": max_new_tokens, "is_victim": is_victim,
            "grow": grow_tokens, "cur": None})
        return sid

    def drain_replica_at(self, t: float, idx: int) -> None:
        """Schedule replica ``idx`` out of the rotation at fleet time
        ``t`` (scale-down): from then on ``route`` sends new arrivals
        elsewhere, while the replica keeps advancing so its in-flight
        requests finish in place — their later ``record_done`` is a
        None-safe no-op on the already-drained router books."""
        heapq.heappush(self._drains, (t, idx))

    # -- fleet loop ----------------------------------------------------------

    # -- autoscaling ---------------------------------------------------------

    def _autoscale_tick(self, now: float) -> None:
        """One autoscaler observation window: difference each active
        replica's pressure snapshot into rates, observe(), and act."""
        from repro_torch.fleet.autoscale import ReplicaSignals
        signals = []
        for i in self._active:
            cur = self.router.stats_fns[i]()
            prev = self._as_prev.get(i)
            done = cur.n_finished + cur.n_timed_out
            resolved = done - self._as_prev_resolved.get(i, 0)
            signals.append(ReplicaSignals.from_stats(prev, cur, resolved))
            self._as_prev[i] = cur
            self._as_prev_resolved[i] = done
        rec = self.autoscaler.observe(signals)
        if rec.action == "scale_up":
            idx = len(self.replicas)
            m = ServingModel(self.p)
            m.start()
            m.advance(now)          # align the newcomer's private clock
            self.replicas.append(m)
            self.router.add_replica(self._stats_fn(idx))
            self._active.append(idx)
            self.n = len(self.replicas)
            self.autoscaler.resize(len(self._active))
            self.scale_log.append((now, "scale_up", len(self._active),
                                   rec.reason))
        elif rec.action == "scale_down" and len(self._active) > 1:
            # drain the NEWEST active replica: route() stops sending it
            # work, in-flight requests finish in place, and its router
            # records are released exactly once (same invariant the
            # manual drain_replica_at path pins)
            idx = self._active.pop()
            orphans = self.router.drain(idx)
            self.drain_log.append((now, idx, orphans))
            self.autoscaler.resize(len(self._active))
            self.scale_log.append((now, "scale_down", len(self._active),
                                   rec.reason))

    def _needs_poll(self) -> bool:
        if any(s["cur"] is not None for s in self._sessions):
            return True
        return self.max_retries > 0 and bool(self.router.outstanding)

    def _dispatch(self, spec: dict, lazy: bool) -> Request:
        base = spec["stream"] << 24
        toks = list(range(base, base + spec["n_tokens"]))
        slo = spec.get("slo")
        if slo is None and self._slo_mix is not None:
            slo = self._slo_mix.next()
        idx = self.router.route(toks, session=spec.get("session"))
        m = self.replicas[idx]
        if lazy:
            m.advance(self._now)
        req = m.inject_now(spec["n_tokens"], spec["max_new_tokens"],
                           is_victim=spec["is_victim"],
                           stream=spec["stream"], slo=slo)
        self.router.record_dispatch(req.req_id, idx)
        self._dispatched.append([req, idx, self.max_retries, False])
        return req

    def _poll(self, now: float) -> None:
        # session turn completions -> schedule the next turn
        for s in self._sessions:
            req = s["cur"]
            if req is not None and req.state in _TERMINAL:
                t_done = req.t_done if req.t_done else now
                s["next_t"] = t_done + s["think"]
                s["cur"] = None
        # fleet-level retry: a starved replica's timeout re-routes ONCE
        # per remaining budget, never back to the same replica
        if self.max_retries > 0:
            for entry in list(self._dispatched):
                req, idx, left, closed = entry
                if (not closed and left > 0
                        and req.state is RequestState.TIMED_OUT):
                    entry[2], entry[3] = 0, True
                    self.router.record_abort(req.req_id)
                    clone = Request(text="",
                                    max_new_tokens=req.max_new_tokens,
                                    req_id=req.req_id,
                                    is_victim=req.is_victim)
                    clone.prompt_tokens = list(req.prompt_tokens)
                    # the clone keeps the original's class/timeout
                    # directly (not via _assign_slo — a retry must not
                    # advance the mix assigner)
                    clone.slo = req.slo
                    clone.timeout = req.timeout
                    new_idx = self.router.route(clone.prompt_tokens,
                                                exclude=(idx,))
                    self.replicas[new_idx].advance(now)
                    self.replicas[new_idx].inject_request(clone)
                    self.router.record_dispatch(clone.req_id, new_idx)
                    self._dispatched.append([clone, new_idx, left - 1,
                                             False])
                    self.n_retries += 1
        # release router bookkeeping for terminal requests (exactly once
        # per dispatch record — the closed flag, not the router, arbitrates
        # between a retried id's original and clone records)
        for entry in self._dispatched:
            if not entry[3] and entry[0].state in _TERMINAL:
                entry[3] = True
                self.router.record_done(entry[0].req_id)

    def run(self, horizon: float = 400.0) -> FleetResult:
        for m in self.replicas:
            m.start()
        # round-robin reads no replica state, so only the target replica
        # needs to be at the arrival time — everyone else keeps an
        # uninterrupted event stream (the conformance guarantee);
        # stats-driven policies must advance the whole fleet to every
        # decision point so snapshots are simultaneous
        lazy = (self.router.cfg.policy == "round-robin"
                and not self._sessions and self.max_retries == 0
                and not self._drains and self.autoscaler is None)
        self._now = 0.0
        while self._now < horizon:
            t_next = horizon
            if self._arrivals:
                t_next = min(t_next, self._arrivals[0][0])
            if self._drains:
                t_next = min(t_next, self._drains[0][0])
            for s in self._sessions:
                if s["cur"] is None and s["n_left"] > 0:
                    t_next = min(t_next, s["next_t"])
            if self._needs_poll():
                t_next = min(t_next, self._now + self.route_quantum)
            if self.autoscaler is not None:
                t_next = min(t_next, self._next_scale)
            t_next = min(max(t_next, self._now), horizon)
            if not lazy:
                for m in self.replicas:
                    m.advance(t_next)
            self._now = t_next
            if self._now >= horizon:
                break
            # drains fire BEFORE same-instant arrivals are routed, so a
            # request arriving at the drain time already re-routes away
            while self._drains and self._drains[0][0] <= self._now:
                _, idx = heapq.heappop(self._drains)
                orphans = self.router.drain(idx)
                self.drain_log.append((self._now, idx, orphans))
            # autoscale ticks fire before same-instant arrivals, so a
            # request arriving at the tick already routes on the resized
            # fleet
            while (self.autoscaler is not None
                   and self._next_scale <= self._now):
                self._autoscale_tick(self._now)
                self._next_scale += self.autoscale_quantum
            if not lazy:
                self._poll(self._now)
            while self._arrivals and self._arrivals[0][0] <= self._now:
                _, _, spec = heapq.heappop(self._arrivals)
                self._dispatch(spec, lazy)
            for s in self._sessions:
                if (s["cur"] is None and s["n_left"] > 0
                        and s["next_t"] <= self._now):
                    spec = dict(n_tokens=(s["n_tokens"]
                                          + s["n_sent"] * s["grow"]),
                                max_new_tokens=s["max_new"],
                                is_victim=s["is_victim"],
                                stream=s["stream"], session=s["key"])
                    s["cur"] = self._dispatch(spec, lazy)
                    s["n_left"] -= 1
                    s["n_sent"] += 1
        for m in self.replicas:
            m.advance(horizon)
        results = [m.finalize() for m in self.replicas]
        # close the books: everything is terminal at the horizon
        for entry in self._dispatched:
            if not entry[3]:
                entry[3] = True
                self.router.record_done(entry[0].req_id)
        stats = self.router.stats()
        stats["n_fleet_retries"] = self.n_retries
        if self.autoscaler is not None:
            stats["scale_log"] = list(self.scale_log)
            stats["n_replicas_final"] = len(self._active)
        return merge_results(results, router=stats)


def fleet_prefix_workload(params: ServingParams, *, n_replicas: int,
                          routing: str, n_sessions: int,
                          requests_per_session: int, prompt_tokens: int,
                          think: float = 0.5, stagger: float = 0.25,
                          max_new_tokens: int = 8,
                          horizon: float = 400.0,
                          route_quantum: float = 0.25,
                          router_cfg=None) -> FleetResult:
    """Prefix-heavy closed-loop fleet workload: ``n_sessions`` chat-style
    sessions, each re-sending its (large) shared prefix every turn —
    affinity routing keeps a session's blocks hot on one replica, while
    blind policies re-prefill the prefix wherever the request lands."""
    fleet = FleetModel(params, n_replicas=n_replicas, routing=routing,
                       route_quantum=route_quantum, router_cfg=router_cfg)
    for s in range(n_sessions):
        fleet.add_session(t_start=s * stagger,
                          n_requests=requests_per_session,
                          n_tokens=prompt_tokens,
                          max_new_tokens=max_new_tokens, think=think)
    return fleet.run(horizon=horizon)


def fleet_open_prefix_workload(params: ServingParams, *, n_replicas: int,
                               routing: str, n_streams: int, rps: float,
                               duration: float, prompt_tokens: int,
                               max_new_tokens: int = 8,
                               horizon: Optional[float] = None,
                               route_quantum: float = 0.25,
                               router_cfg=None) -> FleetResult:
    """Prefix-heavy OPEN-loop fleet workload: arrivals at a fixed fleet
    rate, cycling over ``n_streams`` repeat users (each re-sends its own
    ``prompt_tokens``-token prompt, so every revisit is a full
    prefix-cache hit on a replica that has served the stream before).

    Unlike the closed-loop session workload, arrivals do not wait for
    completions — when blind routing pushes a replica's service rate
    below the offered rate, its queue (and TTFT) diverges, which is how
    the paper's timeout cliff manifests at fleet scale."""
    fleet = FleetModel(params, n_replicas=n_replicas, routing=routing,
                       route_quantum=route_quantum, router_cfg=router_cfg)
    n = int(duration * rps)
    for i in range(n):
        sid = i % n_streams
        fleet.add_request(i / rps, prompt_tokens,
                          max_new_tokens=max_new_tokens,
                          stream=4096 + sid, session=f"stream-{sid}")
    if horizon is None:
        horizon = duration + 4 * params.timeout
    return fleet.run(horizon=horizon)


def llama8b_tp4_params(n_cores: int, tp: int = 4,
                       pool_width: int = 64,
                       preemption_policy: str = "recompute",
                       kv_capacity_tokens: int = 2_300_000) -> ServingParams:
    """Paper-scale preset: Llama-3.1-8B, TP=4, H100/Blackwell-class devices.

    Device coefficients from first principles: prefill 2N FLOPs/token over
    4 chips at ~40% MFU -> ~1e-5 s/token; decode is weight-bandwidth-bound
    -> ~2 ms floor; KV capacity ~2.3M tokens (4x80GB minus weights);
    swapping a 64-token KV block (~8 MB for 8B-class KV) over ~25 GB/s of
    effective PCIe -> ~3e-4 s/block.  Host costs from sim/calibrate.py
    scaled to a Rust-class tokenizer.
    """
    device = DeviceModel(t_fixed=2e-3, t_prefill_tok=1e-5,
                         t_decode_seq=2e-5, t_swap_block=3e-4, max_step=2.0)
    return ServingParams(
        n_cores=n_cores, tp=tp, pool_width=pool_width,
        tok_rate=200_000.0,
        device=device,
        scheduler=SchedulerConfig(max_num_seqs=64,
                                  max_tokens_per_step=8192,
                                  prefill_chunk=2048,
                                  kv_capacity_tokens=kv_capacity_tokens,
                                  preemption_policy=preemption_policy,
                                  swap_capacity_tokens=kv_capacity_tokens,
                                  **device.preemption_calibration()),
    )


def with_async_copies(params: ServingParams, *, copy_streams: int,
                      t_submit_per_copy: float = 5e-6) -> ServingParams:
    """Async-copy-engine variant of ``params`` (docs/copy_engine.md):
    swap/restore (and hybrid handoff) transfers drain on ``copy_streams``
    DMA-style streams concurrently with compute, leaving only the CPU
    submission cost (``t_submit_per_copy`` per block descriptor — the
    CPU-starvation knob benchmarks/copy_overlap.py sweeps) plus any
    un-hidden drain time in the step, and the scheduler runs the
    matching IN_FLIGHT epoch bookkeeping.  ``copy_streams=0`` is the
    serialized baseline, ``params`` itself."""
    device = dataclasses.replace(params.device, copy_streams=copy_streams,
                                 t_submit_per_copy=t_submit_per_copy)
    sched = dataclasses.replace(params.scheduler,
                                **device.copy_calibration())
    decode_device = params.decode_device
    if decode_device is not None:
        decode_device = dataclasses.replace(
            decode_device, copy_streams=copy_streams,
            t_submit_per_copy=t_submit_per_copy)
    return dataclasses.replace(params, device=device, scheduler=sched,
                               decode_device=decode_device)


def with_multi_step(params: ServingParams, *, k: int) -> ServingParams:
    """Multi-step-dispatch variant of ``params`` (docs/multi_step.md):
    decode-steady batches ride k-step macro-plans, so the scheduler /
    broadcast / dispatch / barrier round trip — and the device's
    ``t_fixed`` dispatch floor — are paid once per k decode tokens, the
    CUDA-Graphs analog benchmarks/multi_step.py sweeps.  ``k=1`` is the
    per-step baseline, ``params`` itself."""
    sched = dataclasses.replace(params.scheduler, max_steps_per_dispatch=k)
    return dataclasses.replace(params, scheduler=sched)


def with_speculative(params: ServingParams, *, k: int,
                     accept_rate: float = 0.8,
                     draft_slowdown: float = 8.0,
                     kv_dtype: str = "float32") -> ServingParams:
    """Speculative-decode variant of ``params`` (docs/spec_decode.md):
    the scheduler emits verify plans scoring up to ``k`` CPU-drafted
    candidates per request in one batched step, the draft tier is the
    device's CPU sibling slowed by ``draft_slowdown``, and the verify
    step accepts ``accept_rate`` of the drafts on average — the two axes
    benchmarks/spec_decode.py sweeps for the crossover.  ``kv_dtype=
    "int8"`` additionally halves every KV byte the decode tier's cost
    model charges (swap copies + the KV-bandwidth share of decode).
    The non-speculative baseline is ``params`` itself."""
    sched = dataclasses.replace(params.scheduler, speculative_k=k)
    device, decode_device = params.device, params.decode_device
    if decode_device is not None:
        decode_device = decode_device.with_kv_dtype(kv_dtype)
    else:
        device = device.with_kv_dtype(kv_dtype)
    return dataclasses.replace(
        params, scheduler=sched, device=device,
        decode_device=decode_device,
        draft_device=params.device.cpu_tier(
            decode_slowdown=draft_slowdown),
        spec_accept_rate=accept_rate)


def with_hybrid_decode(params: ServingParams, *,
                       decode_slowdown: float = 8.0,
                       max_decode_seqs: int = 0) -> ServingParams:
    """Split-phase variant of ``params``: decode moves to the device's
    CPU-tier sibling (``DeviceModel.cpu_tier``), the scheduler prices
    decode-tier preemption victims at the CPU tier's swap bandwidth
    (``t_swap_block_decode``), and — optionally — caps the decode tier's
    concurrent slots.  The unified baseline is ``params`` itself, so
    benchmarks/hybrid_split.py sweeps are one ``dataclasses.replace``
    apart."""
    decode_device = params.device.cpu_tier(decode_slowdown=decode_slowdown)
    sched = dataclasses.replace(
        params.scheduler,
        t_swap_block_decode=decode_device.t_swap_block,
        max_decode_seqs=max_decode_seqs)
    return dataclasses.replace(params, decode_device=decode_device,
                               scheduler=sched)


def with_slo(params: ServingParams, mix: str,
             slo_aware: bool = True) -> ServingParams:
    """SLO-tier variant of ``params`` (docs/slo.md): requests are tagged
    per ``mix`` (e.g. ``"interactive:0.3,batch:0.7"``), and the scheduler
    runs class-aware (deadline-ordered admission, rank-aware victims,
    overload shedding) unless ``slo_aware=False`` — the class-BLIND
    baseline that serves the identical tagged workload, so attainment
    deltas isolate the scheduling policy, not the traffic."""
    parse_slo_mix(mix)      # validate eagerly, not at first dispatch
    sched = dataclasses.replace(params.scheduler, slo_aware=slo_aware)
    return dataclasses.replace(params, slo_mix=mix, scheduler=sched)


def mixed_class_workload(params: ServingParams, *, rps: float,
                         duration: float, interactive_share: float,
                         interactive_tokens: int = 256,
                         batch_tokens: int = 6_144,
                         interactive_new_tokens: int = 16,
                         batch_new_tokens: int = 32,
                         horizon: Optional[float] = None) -> WorkloadResult:
    """Open-loop mixed-class workload: short interactive prompts threaded
    between long batch prompts at a fixed arrival rate (docs/slo.md).

    The class determines the SHAPE as well as the tag — interactive
    requests are short-prompt/short-output, batch requests are the long
    prompts whose chunked prefill occupies the token budget interactive
    TTFT deadlines are racing against.  Classes are assigned by the
    deterministic largest-remainder mix, so aware/blind comparisons see
    the byte-identical arrival sequence."""
    if not 0.0 <= interactive_share <= 1.0:
        raise ValueError("interactive_share must be in [0, 1]")
    model = ServingModel(params)
    mix_parts = []
    if interactive_share > 0:
        mix_parts.append((INTERACTIVE, interactive_share))
    if interactive_share < 1:
        mix_parts.append((BATCH, 1.0 - interactive_share))
    mix = SLOMix(mix_parts)
    n = int(duration * rps)
    for i in range(n):
        cls = mix.next()
        if cls is INTERACTIVE:
            n_tok, n_new = interactive_tokens, interactive_new_tokens
        else:
            n_tok, n_new = batch_tokens, batch_new_tokens
        # distinct streams: no cross-request prefix hits muddying the
        # admission-order comparison
        model.add_request(i / rps, n_tok, max_new_tokens=n_new,
                          stream=1 + i, slo=cls)
    if horizon is None:
        horizon = duration + 4 * params.timeout
    return model.run(horizon=horizon)


def attacker_victim_workload(params: ServingParams, *, attacker_rps: float,
                             attacker_tokens: int, n_victims: int = 5,
                             victim_tokens: int = 2_800,
                             duration: float = 30.0,
                             victim_new_tokens: int = 8,
                             attacker_new_tokens: int = 4,
                             victim_start: float = 1.0,
                             victim_spacing: float = 2.0,
                             distinct_attackers: bool = True,
                             horizon: float = 400.0) -> WorkloadResult:
    """The paper's §IV-B experiment: periodic attackers + sequential victims.

    ``attacker_new_tokens`` sets how long each attacker camps in decode
    holding its KV: the paper's CPU-contention runs use short tails (4),
    while the preemption-policy comparison raises it so the resident batch
    outgrows the pool and the KV-capacity cliff is actually reached."""
    model = ServingModel(params)
    t = 0.0
    i = 0
    while t < duration:
        model.add_request(t, attacker_tokens,
                          max_new_tokens=attacker_new_tokens,
                          stream=(1 + i) if distinct_attackers else 1)
        i += 1
        t = i / attacker_rps
    # victims issued SEQUENTIALLY: the next starts when the previous
    # completes (the paper's §IV-B protocol; Fig. 8)
    def victim_issuer():
        yield ("sleep", victim_start)
        for v in range(n_victims):
            req = model.inject_now(victim_tokens,
                                   max_new_tokens=victim_new_tokens,
                                   is_victim=True, stream=0)
            ev = model.sim.event(f"victim-done-{v}")
            model.done_events[req.req_id] = ev
            # wake at completion OR client timeout, whichever first
            model.sim.at(model.sim.now + params.timeout,
                         lambda e=ev: model.sim.fire(e))
            yield ("wait", ev)
            yield ("sleep", victim_spacing)

    model.extra_procs.append(victim_issuer())
    return model.run(horizon=horizon)
