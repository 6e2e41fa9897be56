"""Multi-process LLM serving engine with vLLM-V1's process decomposition.

  client threads -> [API server: tokenizer pool]  (this process)
       | mp.Queue (the ZMQ analogue)
  [EngineCore process: continuous-batching scheduler]
       | ShmBroadcastQueue (1-writer-N-reader, lock-free, busy-wait)
  [worker process x TP]  --compute-->  CompletionBoard barrier
       |
  results mp.Queue -> client

Everything host-side is real (real processes, real /dev/shm ring, real
tokenizer CPU burn); the device step is either emulated from a DeviceModel
(sleep with roofline-derived duration) or, with ``backend="torch"``, the
paged surrogate on the card (or on the CPU when ``torch_device="cpu"``).
This is the instrumented system the paper's experiments (Figs 5-13) run on.

Ported from ``src/repro/core/engine.py``: imports rewritten to
``repro_torch``; ``EngineConfig`` also names the torch device and the
surrogate's arch.  Processes fork, so CUDA is touched only by the
workers, after the fork: the owner builds the kernels with nvcc before
forking and makes no CUDA call.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import multiprocessing as mp
import os
import queue
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch import profiling
from repro_torch.core.devmodel import DeviceModel
from repro_torch.core.shm_broadcast import CompletionBoard, ShmBroadcastQueue
from repro_torch.profiling import ProfilingConfig
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import (BlockTableTracker, Scheduler,
                                           SchedulerConfig, StepPlan)
from repro_torch.tokenizer.bpe import BPETokenizer, default_tokenizer
from repro_torch.tokenizer.pool import TokenizerPool

_CTX = mp.get_context("fork")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    tp_degree: int = 4                      # N workers = N readers
    pool_width: int = 4                     # tokenizer threads
    scheduler: SchedulerConfig = SchedulerConfig()
    device: DeviceModel = DeviceModel()
    backend: str = "emulated"     # worker executor (repro_torch.backend)
    # split-phase children when backend == "hybrid" (docs/backends.md):
    # prefill tier / decode tier leaf backends, and the CPU-tier decode
    # slowdown applied when the decode child is emulated
    prefill_backend: str = "emulated"
    decode_backend: str = "emulated"
    decode_slowdown: float = 8.0
    # speculative decode (docs/spec_decode.md): active when
    # scheduler.speculative_k > 0 — the worker wraps its backend in
    # repro_torch.spec.SpeculativeBackend with this draft child; an
    # emulated draft costs cpu_tier(draft_slowdown) and models acceptance
    # at spec_accept_rate
    draft_backend: str = ""                 # "" = default for the target
    draft_slowdown: float = 8.0
    spec_accept_rate: Optional[float] = None
    # KV pool precision on the decode tier ("float32" | "int8")
    kv_dtype: str = "float32"
    # where every "torch" leaf runs: "cuda" (the default) or "cpu"
    torch_device: str = "cuda"
    # surrogate widths of the physical leaves (repro_torch.backend.
    # ARCH_WIDTHS); None = the reference's default toy widths
    arch: Optional[str] = None
    ring_slots: int = 8
    # 0 = auto-size from the scheduler config: plans carry block tables +
    # input ids, so a slot must hold max_tokens_per_step input ids plus the
    # batch's table entries (disjoint tables are bounded by the pool size;
    # heavy prefix sharing can exceed the bound — raise this explicitly
    # for workloads where many long requests share one prefix)
    ring_slot_bytes: int = 0
    yield_every: int = 0                    # 0 = pure busy-wait (vLLM-style)
    request_timeout: float = 200.0          # the paper's timeout bound
    # async lookahead scheduling (beyond-paper mitigation, §V-B takeaway):
    # overlap scheduling/broadcast of step k+1 with device execution of k.
    async_sched: bool = False
    # publish a Scheduler.pressure_stats() snapshot to the owner every k
    # scheduled steps (0 = off).  A fleet frontend polls these for
    # pressure-feedback routing (docs/fleet.md); snapshots ride a bounded
    # queue and are dropped, never blocked on, when the owner lags.
    pressure_every: int = 0
    # speed-bump injection + trace timeline (docs/profiling.md): inert by
    # default — every process takes the uninstrumented fast path unless
    # this (or REPRO_INJECT/REPRO_TRACE) asks for a profiler
    profiling: ProfilingConfig = ProfilingConfig()

    def resolved_ring_slot_bytes(self) -> int:
        if self.ring_slot_bytes:
            return self.ring_slot_bytes
        s = self.scheduler
        # per-plan table entries are bounded by the pool size (disjoint
        # tables) AND by what max_num_seqs requests can reference (4096
        # blocks/seq covers a 256K-token context at the default block size)
        entries = min(s.num_kv_blocks, 4096 * s.max_num_seqs)
        est = (4096 + 10 * s.max_tokens_per_step
               + 9 * (entries + 16 * s.max_num_seqs))
        # swap directives: ~16 B per (src, dst) block pair, each direction
        # bounded by the host tier (a plan cannot move more blocks than
        # the swap space holds)
        est += 32 * min(entries, s.num_swap_blocks)
        size = 1 << 16
        while size < est:
            size *= 2
        if size > 1 << 22:
            raise ValueError(
                f"auto-sized ring slot ({size} B) exceeds the 4 MiB sanity "
                f"cap for this scheduler config (num_kv_blocks="
                f"{s.num_kv_blocks}, max_num_seqs={s.max_num_seqs}); set "
                f"EngineConfig.ring_slot_bytes explicitly")
        return size

    def leaves(self) -> set:
        """The leaf backends a worker builds: the backend itself or a
        hybrid's two children, plus a speculative draft (make_backend's
        default draft included)."""
        names = ({self.prefill_backend, self.decode_backend}
                 if self.backend == "hybrid" else {self.backend})
        if self.scheduler.speculative_k > 0:
            physical = bool(names & {"torch", "cpu"})
            names.add(self.draft_backend
                      or ("cpu" if physical else "emulated"))
        return names


def _kernel_launches(backend) -> int:
    """Launches of the paged attention kernel in this worker, whichever
    child of a composite backend ran them (every leaf reads the same
    per-process count)."""
    kids = [getattr(backend, a) for a in ("prefill_backend", "decode_backend",
                                          "target", "draft")
            if hasattr(backend, a)]
    return max([getattr(backend, "kernel_launches", 0)]
               + [_kernel_launches(k) for k in kids])


def _graph_books(backend) -> dict:
    """The captured decode steps of this worker (``TorchBackend.graphs``),
    summed over the leaves of a composite backend: graphs captured, the
    host seconds their captures took, and replays."""
    kids = [getattr(backend, a) for a in ("prefill_backend", "decode_backend",
                                          "target", "draft")
            if hasattr(backend, a)]
    graphs = getattr(backend, "graphs", None)
    books = {"graph_captures": 0, "graph_capture_s": 0.0, "graph_replays": 0}
    if graphs is not None:
        books = {"graph_captures": graphs.captures,
                 "graph_capture_s": graphs.capture_s,
                 "graph_replays": graphs.replays}
    for kid in kids:
        for key, val in _graph_books(kid).items():
            books[key] += val
    return books


COMPOSITE_COUNTERS = ("n_handoffs", "n_handoff_blocks", "n_spec_steps",
                      "n_drafted", "n_accepted")


def _composite_counters(backend) -> Dict[str, int]:
    """A hybrid's handoff counts and a speculative wrapper's drafted and
    accepted tokens (a speculative target may itself be a hybrid)."""
    out = {k: getattr(backend, k) for k in COMPOSITE_COUNTERS
           if hasattr(backend, k)}
    if hasattr(backend, "target"):
        out.update(_composite_counters(backend.target))
    return out


def _engine_core(cfg: EngineConfig, in_q, out_q, stats_q, ring_name: str,
                 board_name: str, stop_ev, pressure_q=None) -> None:
    """EngineCore process main loop."""
    prof = profiling.activate(cfg.profiling, role="engine")
    ring = ShmBroadcastQueue.attach(ring_name)
    writer = ring.writer()
    board = CompletionBoard.attach(board_name, cfg.tp_degree)
    sched = Scheduler(cfg.scheduler)
    reqs: Dict[int, Request] = {}
    sched_costs: List[float] = []
    barrier_waits: List[float] = []
    payload_sizes: List[int] = []
    pending_plan: Optional[StepPlan] = None   # async_sched in-flight step

    def emit(req: Request, timed_out: bool = False) -> None:
        out_q.put({
            "req_id": req.req_id, "is_victim": req.is_victim,
            "t_arrival": req.t_arrival,
            "t_tokenize_start": req.t_tokenize_start,
            "t_tokenize_done": req.t_tokenize_done,
            "t_first_token": req.t_first_token,
            "t_done": req.t_done,
            "n_prompt": req.n_prompt,
            "n_generated": len(req.generated),
            "timed_out": timed_out,
            # SLO class name (docs/slo.md) so timeout/attainment rates
            # can be split per class downstream
            "slo": req.slo.name if req.slo is not None else None,
        })
        reqs.pop(req.req_id, None)

    def expire_requests() -> None:
        # the live loop enforces the client timeout too (the seed only
        # ever called sched.expire in the DES), so collect() can't hang
        # waiting on requests that will never finish
        for req in sched.expire(time.perf_counter(), cfg.request_timeout):
            emit(req, timed_out=True)

    def drain_inputs() -> None:
        while True:
            try:
                item = in_q.get_nowait()
            except queue.Empty:
                return
            req = Request(text="", max_new_tokens=item["max_new_tokens"],
                          req_id=item["req_id"],
                          is_victim=item["is_victim"])
            if item.get("slo") is not None:
                # wire decode: the class crossed the queue as a plain dict
                from repro_torch.slo import SLOClass, tag_request
                tag_request(req, SLOClass.from_dict(item["slo"]))
            req.prompt_tokens = item["tokens"]
            req.t_arrival = item["t_arrival"]
            req.t_tokenize_start = item["t_tokenize_start"]
            req.t_tokenize_done = item["t_tokenize_done"]
            reqs[req.req_id] = req
            sched.add_request(req)
            if req.state == RequestState.TIMED_OUT:
                emit(req, timed_out=True)    # rejected: can never fit KV

    def finish_step(plan: StepPlan) -> None:
        if prof is None:
            barrier = board.wait_all(plan.step_id,
                                     yield_every=cfg.yield_every)
        else:
            # trace-only span ("barrier" is not an injection site): shows
            # the engine idling on the workers in the timeline
            with prof.span("barrier", step=plan.step_id):
                barrier = board.wait_all(plan.step_id,
                                         yield_every=cfg.yield_every)
        barrier_waits.append(barrier.wall_s)
        now = time.perf_counter()
        for req in sched.complete_step(plan, now):
            emit(req)

    while not (stop_ev.is_set() and not sched.has_work
               and pending_plan is None):
        drain_inputs()
        expire_requests()
        t0 = time.perf_counter()
        if prof is None:
            plan = sched.schedule()
        else:
            # the span also charges the "scheduler" injection delay, and
            # block_alloc/copy_submit hits land inside schedule() itself
            with prof.span("scheduler", step=sched.step_id):
                plan = sched.schedule()
        sched_costs.append(time.perf_counter() - t0)
        if plan is not None:
            if prof is None:
                raw = plan.encode()
                payload_sizes.append(len(raw))
                writer.enqueue(raw, yield_every=cfg.yield_every)
            else:
                with prof.span("shm_encode", step=plan.step_id):
                    raw = plan.encode()
                payload_sizes.append(len(raw))
                with prof.span("shm_publish", step=plan.step_id):
                    writer.enqueue(raw, yield_every=cfg.yield_every)
            if (pressure_q is not None and cfg.pressure_every > 0
                    and sched.step_id % cfg.pressure_every == 0):
                try:
                    pressure_q.put_nowait(sched.pressure_stats())
                except queue.Full:
                    pass    # stale snapshot beats a blocked control plane
        if cfg.async_sched:
            # lookahead pipeline: wait for the PREVIOUS step while the
            # workers already received (and execute) the current one.
            if pending_plan is not None:
                finish_step(pending_plan)
            pending_plan = plan
            if plan is None and pending_plan is None and not sched.has_work:
                time.sleep(0.0005)
        else:
            if plan is None:
                time.sleep(0.0005)
                continue
            finish_step(plan)
    if pending_plan is not None:
        finish_step(pending_plan)

    # shutdown: sentinel to workers
    writer.enqueue(StepPlan(-1, [], [], []).encode())
    stats_q.put({
        "role": "engine",
        "sched_cost": sched_costs,
        "barrier_wall": barrier_waits,
        "payload_bytes": payload_sizes,
        "slo": sched.slo_snapshot(),
        "trace_events": prof.events if prof is not None else [],
    })
    ring.close()
    board.close()


def _worker(cfg: EngineConfig, idx: int, ring_name: str, board_name: str,
            stats_q) -> None:
    """Per-device worker process: dequeue plan -> execute -> barrier mark.

    Execution goes through the pluggable backend seam: "emulated" keeps
    the calibrated device-model sleep, "torch" runs the paged decode
    kernel for real, "cpu" a plain attention on the CPU, and "hybrid" and
    speculative decode compose them.  The backend is built here, after the
    fork, so the worker makes its own CUDA context; the owner and the
    engine core never touch CUDA."""
    t_start = time.perf_counter()
    # deferred: avoids the core<->backend import cycle at package load
    from repro_torch.backend import make_backend
    leaves = cfg.leaves()
    if "cpu" in leaves or ("torch" in leaves and cfg.torch_device == "cpu"):
        # a child computes on the CPU: an OpenMP pool inherited from the
        # parent does not survive fork, and one intra-op thread keeps the
        # child off it
        import torch
        torch.set_num_threads(1)
    prof = profiling.activate(cfg.profiling, role=f"worker{idx}")
    ring = ShmBroadcastQueue.attach(ring_name)
    reader = ring.reader(idx)
    board = CompletionBoard.attach(board_name, cfg.tp_degree)
    backend = make_backend(cfg.backend, device=cfg.device,
                           scheduler_cfg=cfg.scheduler,
                           prefill_backend=cfg.prefill_backend,
                           decode_backend=cfg.decode_backend,
                           decode_slowdown=cfg.decode_slowdown,
                           kv_dtype=cfg.kv_dtype,
                           draft_backend=cfg.draft_backend,
                           draft_slowdown=cfg.draft_slowdown,
                           spec_accept_rate=cfg.spec_accept_rate,
                           torch_device=cfg.torch_device, arch=cfg.arch)
    # start-up (imports, weights, CUDA context) and per-plan execute wall:
    # what a request that arrives before the worker is ready waits on
    startup_s = time.perf_counter() - t_start
    execute_wall: List[float] = []
    tables = BlockTableTracker()      # delta plans -> full tables
    while True:
        payload, _ = reader.dequeue(timeout=600.0,
                                    yield_every=cfg.yield_every)
        plan = StepPlan.decode_bytes(payload)
        if plan.step_id < 0:
            break
        if prof is None:
            tables.expand(plan)
            res = backend.execute(plan)   # accelerator executes
        else:
            # spans carry the plan's phase so phase_summary can roll up
            # exposed time by prefill/decode/swap/dispatch (docs/profiling.md)
            with prof.span("dispatch", step=plan.step_id, phase=plan.phase):
                tables.expand(plan)
            # trace-only span ("device" is not an injection site): the
            # cover set critical_path_summary subtracts from exposed time
            with prof.span("device", step=plan.step_id, phase=plan.phase):
                res = backend.execute(plan)
        execute_wall.append(res.wall_s)
        board.mark(idx, plan.step_id)
    stats_q.put({
        "role": f"worker{idx}",
        "dequeue_wall": [s.wall_s for s in reader.stats],
        "trace_events": prof.events if prof is not None else [],
        "kernel_launches": _kernel_launches(backend),
        **_graph_books(backend),
        "composite": _composite_counters(backend),
        "startup_s": startup_s,
        "execute_wall": execute_wall,
    })
    ring.close()
    board.close()


class ServingSystem:
    """Owner-side orchestrator (plays the API-server role in-process)."""

    def __init__(self, cfg: EngineConfig = EngineConfig(),
                 tokenizer: Optional[BPETokenizer] = None):
        self.cfg = cfg
        self.tokenizer = tokenizer or default_tokenizer()
        self.ring = ShmBroadcastQueue.create(
            cfg.tp_degree, cfg.ring_slots, cfg.resolved_ring_slot_bytes())
        self.board = CompletionBoard.create(cfg.tp_degree)
        self.in_q = _CTX.Queue()
        self.out_q = _CTX.Queue()
        self.stats_q = _CTX.Queue()
        self.pressure_q = _CTX.Queue(maxsize=64)
        self._last_pressure = None
        self.stop_ev = _CTX.Event()
        self.procs: List[mp.Process] = []
        self.pool: Optional[TokenizerPool] = None
        self.results: Dict[int, dict] = {}
        self.stats: List[dict] = []
        self._next_id = 0
        self._lock = threading.Lock()
        self._encode_futs: List["cf.Future"] = []
        self._prof = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingSystem":
        # activate AFTER process creation below would also work (children
        # install their own profiler post-fork regardless), but doing it
        # first keeps the owner's t0 earlier than any child event
        self._prof = profiling.activate(self.cfg.profiling, role="api")
        if "torch" in self.cfg.leaves() and self.cfg.torch_device != "cpu":
            # build the kernels once, before the fork, so that the workers
            # do not race on the build directory; nvcc only, no CUDA call
            from repro_torch.kernels._build import build_library
            build_library()
        eng = _CTX.Process(
            target=_engine_core,
            args=(self.cfg, self.in_q, self.out_q, self.stats_q,
                  self.ring.name, self.board.name, self.stop_ev,
                  self.pressure_q),
            daemon=True, name="engine-core")
        eng.start()
        self.procs.append(eng)
        for i in range(self.cfg.tp_degree):
            w = _CTX.Process(
                target=_worker,
                args=(self.cfg, i, self.ring.name, self.board.name,
                      self.stats_q),
                daemon=True, name=f"worker-{i}")
            w.start()
            self.procs.append(w)
        # tokenizer threads AFTER forking (fork + threads don't mix)
        self.pool = TokenizerPool(self.tokenizer, self.cfg.pool_width,
                                  measure=True)
        return self

    def submit(self, text: str, max_new_tokens: int = 8,
               is_victim: bool = False, slo=None) -> int:
        """Submit one request.  ``slo`` (a ``repro.slo.SLOClass``) tags it
        with a latency class; the class rides the input queue as a dict
        and the EngineCore re-applies it (docs/slo.md)."""
        with self._lock:
            rid = self._next_id
            self._next_id += 1
        t_arrival = time.perf_counter()
        slo_wire = slo.to_dict() if slo is not None else None
        prof = self._prof

        def tokenize_and_enqueue() -> List[int]:
            t_tok0 = time.perf_counter()
            if prof is None:
                toks = self.tokenizer.encode(text)
            else:
                # span runs on a pool thread; list.append is atomic under
                # the GIL, so the collection stays lock-free
                with prof.span("tokenize", req=rid):
                    toks = self.tokenizer.encode(text)
            t_tok1 = time.perf_counter()
            self.in_q.put({
                "req_id": rid, "tokens": toks,
                "max_new_tokens": max_new_tokens, "is_victim": is_victim,
                "t_arrival": t_arrival, "t_tokenize_start": t_tok0,
                "t_tokenize_done": t_tok1, "slo": slo_wire,
            })
            return toks

        if self.pool is not None:
            fut = self.pool.submit(tokenize_and_enqueue)
            if self.pool.pool_width == 1:
                fut.result()   # ran inline: propagate errors immediately
            else:
                # retain the future: encode exceptions on pool threads must
                # not vanish silently — shutdown() re-raises the first one
                with self._lock:
                    self._encode_futs = [
                        f for f in self._encode_futs
                        if not f.done() or f.exception() is not None]
                    self._encode_futs.append(fut)
        else:
            tokenize_and_enqueue()
        return rid

    def pressure_stats(self):
        """Latest engine-published pressure snapshot (or None before the
        first publish / with ``pressure_every == 0``).  Drains the queue —
        only the freshest snapshot matters to a router."""
        while True:
            try:
                self._last_pressure = self.pressure_q.get_nowait()
            except queue.Empty:
                break
        return self._last_pressure

    def collect(self, n: int, timeout: float = 300.0) -> Dict[int, dict]:
        """Gather ``n`` results; raises as soon as the engine core or a
        worker has died (its own error is on stderr) rather than waiting
        out ``timeout``."""
        deadline = time.monotonic() + timeout
        while len(self.results) < n and time.monotonic() < deadline:
            try:
                rec = self.out_q.get(timeout=0.2)
                self.results[rec["req_id"]] = rec
            except queue.Empty:
                dead = [p for p in self.procs if not p.is_alive()]
                if dead and not self.stop_ev.is_set():
                    raise RuntimeError(
                        f"{dead[0].name} exited with code "
                        f"{dead[0].exitcode} with requests outstanding")
        return self.results

    def shutdown(self, timeout: float = 30.0) -> List[dict]:
        self.stop_ev.set()
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(0.1, deadline - time.monotonic()))
        while True:
            try:
                self.stats.append(self.stats_q.get_nowait())
            except queue.Empty:
                break
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        if self.pool:
            self.pool.shutdown()
        self.ring.close()
        self.board.close()
        # surface the first tokenizer-pool encode failure (after cleanup,
        # so a bad request can't leak processes or shm segments); in-flight
        # encodes still drain on the pool threads, so wait for them first
        with self._lock:
            futs, self._encode_futs = self._encode_futs, []
        if futs:
            cf.wait(futs, timeout=5.0)
        for fut in futs:
            if fut.done() and fut.exception() is not None:
                raise fut.exception()
        if self._prof is not None:
            # appended last so every pool-thread tokenize span has landed
            self.stats.append({"role": "api",
                               "trace_events": list(self._prof.events)})
            self._prof = None
            profiling.deactivate()
        return self.stats
