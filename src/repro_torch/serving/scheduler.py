"""Continuous-batching scheduler with chunked prefill + paged KV blocks.

Mirrors vLLM V1's scheduling model: every step the EngineCore re-decides
the batch (this per-step dynamic decision is exactly why CUDA-Graph-style
whole-sequence capture cannot remove the CPU from the loop — paper §II-A③):

  * running decodes get one slot each (decode-priority, bounded by
    ``max_num_seqs``);
  * remaining token budget (``max_tokens_per_step``) is filled with prefill
    chunks from the waiting queue (chunked prefill);
  * KV is managed at block granularity by ``repro.serving.blocks``: every
    request carries a block table, admission/growth allocate blocks, and
    when allocation fails the most recently admitted running request is
    *preempted* — by recompute (blocks freed, requeued at the head; its
    next prefill usually resumes cheaply from the prefix cache), by
    swap-to-host (blocks copied to the bounded ``HostSwapSpace`` tier and
    restored on re-admission), or adaptively per request, comparing the
    recompute cost of its computed tokens against the calibrated
    swap-bandwidth cost (``SchedulerConfig.preemption_policy``, see
    docs/preemption.md);
  * swapped requests are re-admitted ahead of fresh prefill work as soon
    as device blocks free up — the plan carries their (host, device)
    restore directives so the backends copy the pages back.  With the
    async copy engine enabled (``copy_streams >= 1``,
    docs/copy_engine.md) the restore is IN_FLIGHT for one step: the
    request parks in ``RESTORING`` and only re-enters the batch when its
    transfer's epoch completes, and a swap-out victim's source blocks
    stay held until the copy-out lands — so no page is ever read before
    its copy completes, and a freed block can never be reallocated
    mid-transfer;
  * the preemption victim is picked by ``victim_selection``: ``lifo``
    (most recently admitted, vLLM-style) or ``cheapest`` (the running
    request whose eviction costs least under the active policy —
    cache-resumable recomputes and short swap round-trips go first);
  * refcounted prefix-cache blocks let identical prompt prefixes skip
    prefill work (attackers in the paper's experiment send identical
    prompts — vLLM's prefix caching is on by default, so we model it too).

The scheduler is pure control-plane: it never touches tensors, so its CPU
cost is measurable in isolation (repro.sim calibration).  The StepPlan it
emits carries the per-request block tables and input token ids — the
broadcast payload therefore scales with batch size the way a real
engine's does (paper §V-B).

Copied from ``src/repro/serving/scheduler.py``, with its imports
rewritten to ``repro_torch``.  ``pressure_stats(with_prefix_summary=True)``
raises until the fleet router is ported (it builds the summary).
"""
from __future__ import annotations

import collections
import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.blocks import BlockManager, HostSwapSpace, chain_key
from repro_torch.serving.request import Request, RequestState
from repro_torch.slo import STANDARD, slack_bucket

# transfer kinds for the async copy engine (mirrors repro.core.copyengine,
# which cannot be imported at module level: repro.core.__init__ pulls in
# devmodel, which imports this module)
SWAP_OUT, RESTORE = "swap_out", "restore"

PREEMPTION_POLICIES = ("recompute", "swap", "adaptive")
VICTIM_SELECTIONS = ("lifo", "cheapest")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_num_seqs: int = 64             # max concurrent sequences in a step
    max_tokens_per_step: int = 8192    # token budget (decode=1, prefill=n)
    prefill_chunk: int = 2048          # max prefill tokens per request/step
    enable_prefix_cache: bool = True
    kv_capacity_tokens: int = 1 << 22  # total KV slots across the batch
    block_size: int = 64               # KV tokens per page
    # what to do with a victim's computed KV when allocation fails:
    #   recompute — free it, re-prefill on re-admission (vLLM default);
    #   swap      — copy blocks to the host tier, restore on re-admission;
    #   adaptive  — per request: swap iff the modeled round-trip transfer
    #               is cheaper than re-prefilling its computed tokens.
    preemption_policy: str = "recompute"
    swap_capacity_tokens: int = 1 << 22   # host tier size (swap/adaptive)
    # adaptive cost calibration (seconds) — wire these from DeviceModel
    # (t_swap_block, t_prefill_tok) so the decision matches the device
    # the swap actually runs on; defaults match DeviceModel's defaults
    t_swap_block: float = 5e-5         # host<->device copy per block
    t_recompute_token: float = 2e-6    # re-prefill per computed token
    # hysteresis: swap only when the round trip is this many times cheaper
    # than recompute.  Transfers serialize the device step (no overlap in
    # this stack) and a swapped request pins host blocks while it waits,
    # so a marginal modeled win is a measured loss.
    swap_margin: float = 2.0
    # -- split-phase (hybrid) tier awareness, docs/backends.md ----------
    # Swap bandwidth for victims whose KV lives on the DECODE tier: under
    # a hybrid backend a decoding request's pages sit in CPU memory, so
    # "swapping" them is a host-local copy, far cheaper than the PCIe
    # trip an accelerator-tier victim pays.  < 0 means "same as
    # t_swap_block" (unified execution — every victim is device-tier).
    t_swap_block_decode: float = -1.0
    # Decode-tier capacity: at most this many decode slots per step (the
    # CPU tier serves fewer concurrent sequences than the accelerator).
    # Admission stays bounded by max_num_seqs; this bounds how many of
    # the admitted may *decode* in one step, round-robin so none starve.
    # 0 = uncapped (unified execution).
    max_decode_seqs: int = 0
    # -- async copy engine (repro.core.copyengine, docs/copy_engine.md) --
    # 0 = serialized transfers (pre-engine behavior: a restore and the
    # restored request's compute ride one plan, swap-out sources free
    # immediately).  >= 1: swap/restore copies get completion epochs —
    # the blocks they touch stay IN_FLIGHT until the submitting step
    # executes, and a restored request parks in RESTORING for that step.
    # Must match the executing DeviceModel's ``copy_streams`` (wire it
    # from ``DeviceModel.copy_calibration()``).
    copy_streams: int = 0
    # -- preemption victim choice (ROADMAP follow-on) -------------------
    #   lifo     — evict the most recently admitted running request
    #              (vLLM-style priority order);
    #   cheapest — evict the running request whose eviction is cheapest
    #              under the active policy (re-prefill seconds of its
    #              non-cache-resumable tokens vs its swap round trip).
    victim_selection: str = "lifo"
    # -- delta block tables (docs/copy_engine.md) -----------------------
    # Broadcast only the newly appended blocks of each request's table
    # per step (plus a resync-safe base count); workers reconstruct via
    # ``BlockTableTracker``.  False = every plan ships full tables.
    delta_block_tables: bool = True
    # -- multi-step dispatch (docs/multi_step.md) -----------------------
    # When the batch is decode-steady (no prefill, no queued admissions,
    # no swap traffic in flight), emit a k-step macro-plan: workers run
    # up to k decode iterations per broadcast/barrier round trip, the
    # CUDA-Graphs analog that amortizes the per-step control-plane floor
    # (paper §II-A③).  KV growth for all k steps is pre-reserved (k
    # shrinks to what fits); per-request budgets are capped at the
    # remaining decode length; EOS/max-len early exits roll the unused
    # reservation back at completion.  1 = per-step dispatch (default).
    max_steps_per_dispatch: int = 1
    # -- per-tier macro eligibility (docs/multi_step.md) ----------------
    # Relax the decode-steady requirement: a plan may still extend into a
    # macro (or speculative verify) while OTHER running requests are
    # mid-prefill, as long as every running request is covered by this
    # very plan (decoding in it, or its prefill chunk rides it).  Under a
    # split-phase backend this lets the decode tier run k steps while
    # the prefill tier chews a long prompt — the PR-6 follow-on.  Swap
    # traffic / queues / drop notices still force per-step dispatch.
    per_tier_macros: bool = False
    # -- speculative decoding (docs/spec_decode.md) ---------------------
    # k > 0: eligible decode plans become speculative verify plans
    # (num_steps = k + 1): the draft child decodes up to k candidate
    # tokens per request worker-side, the verify child scores them all in
    # one batched step, and the accepted prefix + correction token come
    # back through the macro-plan ``token_steps`` stream (rejected-suffix
    # KV is rolled back like an EOS early-exit).  Takes precedence over
    # ``max_steps_per_dispatch`` when both are set.  0 = off.
    speculative_k: int = 0
    # -- victim selection: time-to-release term (docs/preemption.md) ----
    # Modeled seconds of device decode per token the victim still owes
    # before it would release its blocks anyway.  A victim near the end
    # of its decode frees memory soon without help, so evicting it buys
    # almost nothing: its remaining decode length is priced into
    # ``_eviction_cost`` and "cheapest" prefers short-remaining victims.
    # Wire from ``DeviceModel.preemption_calibration()`` (t_decode_seq);
    # 0 disables the term.
    t_release_token: float = 1e-4
    # -- overload-aware adaptive preemption (docs/preemption.md) --------
    # The adaptive policy falls back to recompute while the observed
    # re-eviction rate (restored requests evicted again) exceeds this
    # fraction: under sustained overload the swap tier cycles KV back
    # and forth without retiring work, so the modeled per-victim win
    # never materializes.  Counters decay, so swap is re-probed once
    # pressure eases.  > 1 disables the feedback.
    re_evict_threshold: float = 0.5
    re_evict_min_samples: int = 4      # restores observed before acting
    # -- SLO latency classes (repro.slo, docs/slo.md) -------------------
    # Turns on class-aware scheduling for requests tagged with an
    # SLOClass: EDF-flavored waiting-queue admission (ordered by slack to
    # each request's TTFT deadline — only when >= 2 distinct classes are
    # queued, so single-class plans stay bit-identical to the class-blind
    # path), per-class prefill_chunk caps, a class-rank term in victim
    # selection (best-effort evicted before interactive), and overload
    # shedding.  Per-class attainment ACCOUNTING is always on for tagged
    # requests regardless of this flag, so a class-blind baseline still
    # reports attainment.
    slo_aware: bool = False
    # overload shedding: while classes with rank >= shed_min_rank show a
    # sustained TTFT-deadline miss rate above shed_miss_threshold
    # (counters decay with the overload window, so shedding is re-probed
    # once pressure eases), waiting requests with rank < shed_min_rank
    # are deprioritized — parked in the queue, not admitted — whenever
    # anything else could use the step.
    shed_min_rank: int = 1
    shed_miss_threshold: float = 0.5
    shed_min_samples: int = 4

    def __post_init__(self):
        if self.max_steps_per_dispatch < 1:
            raise ValueError(
                f"max_steps_per_dispatch={self.max_steps_per_dispatch} "
                f"(want >= 1)")
        if self.speculative_k < 0:
            raise ValueError(
                f"speculative_k={self.speculative_k} (want >= 0)")
        if self.preemption_policy not in PREEMPTION_POLICIES:
            raise ValueError(
                f"preemption_policy={self.preemption_policy!r} "
                f"(want one of {PREEMPTION_POLICIES})")
        if self.victim_selection not in VICTIM_SELECTIONS:
            raise ValueError(
                f"victim_selection={self.victim_selection!r} "
                f"(want one of {VICTIM_SELECTIONS})")

    @property
    def multi_step(self) -> bool:
        return self.max_steps_per_dispatch > 1

    @property
    def num_kv_blocks(self) -> int:
        return max(1, self.kv_capacity_tokens // self.block_size)

    @property
    def num_swap_blocks(self) -> int:
        if self.preemption_policy == "recompute":
            return 0
        return max(1, self.swap_capacity_tokens // self.block_size)


@dataclasses.dataclass
class StepPlan:
    """One scheduling decision — the broadcast payload (paper §V-B)."""
    step_id: int
    prefill: List[Tuple[int, int, int]]   # (req_id, start, length)
    decode: List[int]                      # req_ids generating 1 token
    preempted: List[int]                   # req_ids whose state the workers
                                           # must drop: recompute-evicted or
                                           # aborted while swapped
    block_tables: Dict[int, List[int]] = dataclasses.field(
        default_factory=dict)              # req_id -> KV block ids
    new_tokens: Dict[int, List[int]] = dataclasses.field(
        default_factory=dict)              # req_id -> input token ids
    # swap directives — backends MUST apply swap_outs, then restores,
    # before any prefill/decode writes of the same step (a freed device
    # block may be reallocated within this very plan):
    swap_outs: Dict[int, List[Tuple[int, int]]] = dataclasses.field(
        default_factory=dict)              # req_id -> [(device_blk, host_blk)]
    restores: Dict[int, List[Tuple[int, int]]] = dataclasses.field(
        default_factory=dict)              # req_id -> [(host_blk, device_blk)]
    # phase tagging: req_ids whose prompt finishes prefilling this step.
    # Advisory for most backends; split-phase backends (repro.backend.
    # hybrid) key their prefill->decode KV handoff on it.
    prefill_done: List[int] = dataclasses.field(default_factory=list)
    # phase tagging for swap traffic: req_ids whose ``swap_outs`` (evicted
    # while DECODING) or ``restores`` (resuming decode) move KV that lives
    # on the decode tier under a split-phase backend.  Lets cost-only
    # consumers route/bill the copies against the tier the scheduler
    # priced them at — a swap victim is dropped from decode/prefill, and
    # a restored decoder may be rotated out of ``decode`` by the
    # max_decode_seqs cap, so the phase is otherwise unrecoverable from
    # the plan.
    decode_tier_swaps: List[int] = dataclasses.field(default_factory=list)
    # delta block tables: table_base[rid] = how many leading entries of
    # rid's table the workers already hold (tables are append-only
    # between resets, and every reset path clears the sent-count, so the
    # known prefix is always valid).  ``block_tables`` above always
    # holds FULL tables in-process; only ``encode`` ships the tail —
    # ``BlockTableTracker.expand`` rebuilds full tables after decode.
    table_base: Dict[int, int] = dataclasses.field(default_factory=dict)
    # -- multi-step macro-plan (docs/multi_step.md) ---------------------
    # num_steps > 1: workers run up to ``num_steps`` decode iterations
    # for this one broadcast.  ``decode_steps[rid]`` is the per-request
    # inner-step budget (min(num_steps, remaining decode) — KV for all
    # of it is pre-reserved in the shipped table); ``eos_tokens[rid]``
    # lets the device loop stop feeding a sequence that sampled its EOS.
    # Inner steps own consecutive step ids ``step_id .. last_step_id``,
    # so copy-engine epochs stay sub-step-granular.  Macro-plans are
    # decode-only by construction: never prefill/swap/notice work.
    num_steps: int = 1
    decode_steps: Dict[int, int] = dataclasses.field(default_factory=dict)
    eos_tokens: Dict[int, int] = dataclasses.field(default_factory=dict)
    # -- speculative verify plan (docs/spec_decode.md) ------------------
    # speculative=True: a macro-shaped plan whose ``decode_steps[rid]``
    # budget b covers ONE verify pass over [carried token, k drafts]
    # rather than b sequential decode iterations.  ``draft_tokens`` is
    # worker-side transient state (the draft child's candidates, attached
    # by repro.spec.SpeculativeBackend after drafting) — it NEVER ships
    # on the wire: each worker drafts deterministically from the same
    # seed, so re-broadcasting the candidates would be redundant bytes.
    speculative: bool = False
    draft_tokens: Dict[int, List[int]] = dataclasses.field(
        default_factory=dict, compare=False)
    _raw: Optional[bytes] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def last_step_id(self) -> int:
        """Step id of the final inner iteration (== step_id when k=1)."""
        return self.step_id + self.num_steps - 1

    @property
    def phase(self) -> str:
        """Coarse step phase for profiling rollups (docs/profiling.md):
        ``swap`` when transfer directives ride the plan, else the compute
        mix (``prefill``/``decode``/``mixed``); a notice-only plan is
        pure ``dispatch``."""
        if self.swap_outs or self.restores:
            return "swap"
        if self.prefill and self.decode:
            return "mixed"
        if self.prefill:
            return "prefill"
        if self.decode:
            return "decode"
        return "dispatch"

    @property
    def n_tokens(self) -> int:
        return sum(l for _, _, l in self.prefill) + len(self.decode)

    @property
    def n_swapped_blocks(self) -> int:
        """Blocks crossing the host<->device boundary this step."""
        return (sum(len(p) for p in self.swap_outs.values())
                + sum(len(p) for p in self.restores.values()))

    @property
    def n_new_table_entries(self) -> int:
        """Block-table entries actually broadcast this step (the delta
        under delta encoding; the full tables otherwise) — the quantity
        the per-entry device upload cost scales with."""
        return sum(len(t) - self.table_base.get(rid, 0)
                   for rid, t in self.block_tables.items())

    def encode(self) -> bytes:
        if self._raw is None:
            payload = {
                "step": self.step_id,
                "prefill": self.prefill,
                "decode": self.decode,
                "preempted": self.preempted,
                # only the unsent tail ships; table_base carries the
                # worker-known prefix length for reconstruction
                "block_tables": {
                    rid: t[self.table_base.get(rid, 0):]
                    for rid, t in self.block_tables.items()},
                "new_tokens": self.new_tokens,
                "swap_outs": self.swap_outs,
                "restores": self.restores,
                "prefill_done": self.prefill_done,
                "decode_tier_swaps": self.decode_tier_swaps,
            }
            if self.table_base:
                payload["table_base"] = self.table_base
            if self.num_steps > 1:
                payload["num_steps"] = self.num_steps
                payload["decode_steps"] = self.decode_steps
                if self.eos_tokens:
                    payload["eos_tokens"] = self.eos_tokens
                if self.speculative:
                    payload["speculative"] = True
            self._raw = json.dumps(payload).encode()
        return self._raw

    @classmethod
    def decode_bytes(cls, raw: bytes) -> "StepPlan":
        """Rebuild a plan from the wire.  ``block_tables`` holds only the
        delta tails until ``BlockTableTracker.expand`` reconstructs the
        full tables from the reader's history."""
        d = json.loads(raw)
        return cls(d["step"], [tuple(p) for p in d["prefill"]],
                   d["decode"], d["preempted"],
                   {int(k): v for k, v in d.get("block_tables", {}).items()},
                   {int(k): v for k, v in d.get("new_tokens", {}).items()},
                   {int(k): [tuple(p) for p in v]
                    for k, v in d.get("swap_outs", {}).items()},
                   {int(k): [tuple(p) for p in v]
                    for k, v in d.get("restores", {}).items()},
                   d.get("prefill_done", []),
                   d.get("decode_tier_swaps", []),
                   table_base={int(k): v
                               for k, v in d.get("table_base", {}).items()},
                   num_steps=d.get("num_steps", 1),
                   decode_steps={int(k): v
                                 for k, v in d.get("decode_steps",
                                                   {}).items()},
                   eos_tokens={int(k): v
                               for k, v in d.get("eos_tokens", {}).items()},
                   speculative=d.get("speculative", False))

    @property
    def payload_bytes(self) -> int:
        """Actual broadcast size (serializes once, cached)."""
        return len(self.encode())

    def approx_payload_bytes(self) -> int:
        """Cheap estimate of the JSON wire size for the DES (avoids paying
        real serialization inside simulated sweeps)."""
        if self._raw is not None:
            return len(self._raw)
        n_bt = self.n_new_table_entries        # only the delta tail ships
        n_nt = sum(len(t) for t in self.new_tokens.values())
        return (96 + 18 * len(self.prefill) + 8 * len(self.decode)
                + 8 * len(self.preempted) + 7 * n_bt + 9 * n_nt
                + 12 * (len(self.block_tables) + len(self.new_tokens))
                + 14 * len(self.table_base)
                + 14 * self.n_swapped_blocks
                + 12 * (len(self.swap_outs) + len(self.restores))
                + 8 * len(self.prefill_done)
                + 8 * len(self.decode_tier_swaps)
                + (30 + 12 * len(self.decode_steps)
                   + 12 * len(self.eos_tokens)
                   + (20 if self.speculative else 0)
                   if self.num_steps > 1 else 0))


class BlockTableTracker:
    """Reader-side reconstruction of delta-encoded block tables.

    Each worker keeps the last full table it saw per request; a decoded
    plan's ``block_tables[rid]`` holds only the appended tail and
    ``table_base[rid]`` says how long the known prefix is.  ``expand``
    rebuilds the full tables in place, so everything downstream of the
    ring (backends, device models) keeps seeing complete tables.  The
    scheduler resends a FULL table (base 0) after every reset — preempt,
    swap-out, restore, finish — so history can never go stale; entries
    are LRU-bounded well above ``max_num_seqs`` (finished requests are
    never announced on the one-way ring, they just age out).
    """

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self._tables: "collections.OrderedDict[int, List[int]]" = \
            collections.OrderedDict()

    def expand(self, plan: "StepPlan") -> "StepPlan":
        for rid in plan.preempted:
            self._tables.pop(rid, None)
        for rid, tail in list(plan.block_tables.items()):
            base = plan.table_base.get(rid, 0)
            if base:
                known = self._tables.get(rid, [])
                assert len(known) >= base, (
                    f"delta plan for req {rid} assumes {base} known "
                    f"entries, reader holds {len(known)}")
                full = known[:base] + tail
            else:
                full = list(tail)
            plan.block_tables[rid] = full
            self._tables[rid] = full
            self._tables.move_to_end(rid)
        while len(self._tables) > self.max_entries:
            self._tables.popitem(last=False)
        return plan


@dataclasses.dataclass(frozen=True)
class PressureStats:
    """One replica's admission/KV-pressure snapshot for fleet routing.

    Built by ``Scheduler.pressure_stats()`` from BlockManager/queue ground
    truth at call time — every field is re-derived, nothing is cached, so a
    router polling between steps can never see double-counted pressure.
    ``n_preempted``/``n_timed_out`` are cumulative counters (rates come from
    differencing two snapshots); ``cpu_saturation`` is whatever the caller
    last reported via ``note_cpu_saturation`` (the scheduler itself cannot
    observe wall-clock CPU).  ``prefix_summary`` is an optional
    ``repro.fleet.PrefixSummary`` bloom over the resident prefix-cache
    chain keys — false positives allowed, false negatives never (at
    snapshot time).
    """
    step_id: int
    free_blocks: int
    total_blocks: int
    queue_depth: int          # tokenized requests waiting for admission
    n_running: int
    n_swapped: int
    n_restoring: int
    in_flight_copies: int     # copy-engine transfers not yet retired
    kv_used_tokens: int
    cached_blocks: int        # prefix-cache entries resident (incl. evictable)
    n_preempted: int          # cumulative evictions (recompute + swap)
    n_timed_out: int          # cumulative client timeouts + up-front rejects
    cpu_saturation: float = 0.0
    n_finished: int = 0       # cumulative completions (rate via differencing)
    # per-class SLO attainment snapshot (docs/slo.md): None when no tagged
    # request has been observed, else {"classes": {name: counters +
    # attainment fractions + slack_hist}, "shedding": bool}.  Counters are
    # cumulative, like n_preempted/n_timed_out.
    slo: Optional[dict] = None
    prefix_summary: Optional[object] = None

    def slo_miss_rate(self, min_rank: int = 2, min_samples: int = 4) -> float:
        """Worst TTFT-deadline miss fraction among classes with rank >=
        ``min_rank`` (interactive tier by default) — the term fleet
        routing folds into replica load so dispatch prefers replicas
        meeting the interactive SLO.  Timeouts count as misses; 0.0 when
        no such class has enough samples."""
        if not self.slo:
            return 0.0
        worst = 0.0
        for c in self.slo["classes"].values():
            n = c["n_first"] + c["n_timeouts"]
            if c["rank"] >= min_rank and n >= min_samples:
                worst = max(worst, (n - c["n_ttft_ok"]) / n)
        return worst

    @property
    def kv_pressure(self) -> float:
        """Fraction of the device pool not allocatable right now."""
        return 1.0 - self.free_blocks / max(1, self.total_blocks)

    @property
    def occupancy(self) -> int:
        """Requests holding or awaiting KV state on this replica."""
        return self.n_running + self.n_swapped + self.n_restoring


class Scheduler:
    def __init__(self, cfg: SchedulerConfig = SchedulerConfig()):
        self.cfg = cfg
        self.waiting: List[Request] = []
        self.running: List[Request] = []
        self.swapped: List[Request] = []   # swapped out, FIFO re-admission
        # restore copy in flight (async copy engine): re-enters running
        # when the transfer's epoch retires, never victimizable meanwhile
        self.restoring: List[Request] = []
        # aborted-while-swapped rids awaiting a state-drop notice to the
        # workers (shipped via the next broadcast plan's ``preempted``)
        self._dropped_while_swapped: List[int] = []
        # in-flight transfer bookkeeping (None = serialized transfers)
        self.copies = None
        if cfg.copy_streams > 0:
            from repro_torch.core.copyengine import CopyEngine
            self.copies = CopyEngine(cfg.copy_streams)
        # a compute allocation was parked last step waiting on deferred
        # frees: give it first claim on the landed blocks before the
        # swapped queue restores into them (else restores starve compute
        # forever and every round trip is futile — see step 0 below)
        self._defer_pending = False
        # delta block tables: entries of each rid's table already
        # broadcast (cleared on every table reset so deltas stay valid)
        self._sent_blocks: Dict[int, int] = {}
        # round-robin cursor over decoders when max_decode_seqs caps the
        # decode tier (fairness: the cap must not starve the tail)
        self._decode_cursor = 0
        # overload-aware adaptive preemption: observed restore count and
        # how many victims were previously-restored requests (re-evicted
        # — the swap round trip bought nothing).  Both halve every
        # ``_OVERLOAD_WINDOW`` steps, so once the fallback quiets the
        # swap tier the sample count decays below re_evict_min_samples
        # and the policy re-probes swap.
        self._n_restores = 0
        self._n_re_evicts = 0
        self._overload_tick = 0
        # cumulative pressure counters (fleet routing / autoscaling signals)
        self.n_preempted_total = 0
        self.n_timed_out_total = 0
        self.n_finished_total = 0
        # per-class SLO attainment counters (docs/slo.md) — always
        # maintained for tagged requests; cfg.slo_aware only gates
        # scheduling BEHAVIOR, so a class-blind baseline still reports
        # attainment for comparison
        self._slo_acct: Dict[str, dict] = {}
        # shedding window: TTFT-deadline outcomes of protected classes
        # (rank >= shed_min_rank); decayed with the overload window
        self._shed_samples = 0
        self._shed_misses = 0
        # last externally reported CPU saturation (0..1); the engine/DES
        # owns the measurement, the scheduler just carries it into
        # ``pressure_stats`` snapshots
        self.cpu_saturation = 0.0
        self.step_id = 0
        swap = None
        if cfg.num_swap_blocks > 0:
            swap = HostSwapSpace(cfg.num_swap_blocks, cfg.block_size)
        self.blocks = BlockManager(
            cfg.num_kv_blocks, cfg.block_size,
            enable_prefix_cache=cfg.enable_prefix_cache,
            swap_space=swap)

    # -- queue management ----------------------------------------------------

    def add_request(self, req: Request) -> None:
        assert req.prompt_tokens is not None, "tokenize before scheduling"
        full_need = -(-(req.n_prompt + req.max_new_tokens)
                      // self.cfg.block_size)
        if full_need > self.cfg.num_kv_blocks:
            # can never fit the pool: reject up front (client-visible abort,
            # same terminal state as a timeout) instead of parking it at the
            # queue head where it would head-of-line-block all admission
            req.state = RequestState.TIMED_OUT
            self.n_timed_out_total += 1
            self._note_timeout(req)
            return
        if self.cfg.enable_prefix_cache:
            # probe only (no locks while waiting); the hit is re-resolved —
            # and the blocks actually locked — at admission, since eviction
            # may shrink it meanwhile.  Cap at n_prompt - 1: the last token
            # must be computed to produce the first output logits.
            hit, _ = self.blocks.match_prefix(
                req.prompt_tokens, max_tokens=max(req.n_prompt - 1, 0))
            req.prefilled = hit
        req.state = RequestState.WAITING
        self.waiting.append(req)

    # -- KV accounting -------------------------------------------------------
    # All KV state lives in the block manager: a request's charge is exactly
    # its block table, so alloc/free are symmetric by construction (shared
    # prefix blocks are refcounted, never double-freed or double-counted).

    @property
    def kv_used(self) -> int:
        """Token slots in blocks referenced by live requests."""
        return self.blocks.used_blocks * self.cfg.block_size

    def _blocks_needed(self, req: Request, n_tokens: int) -> int:
        """New blocks ``req`` must acquire to hold ``n_tokens`` more
        slots — the ONE accounting both `_alloc_slots` and the parking
        guard in `_allocate_with_preemption` use (parking on in-flight
        frees is only sound against the same ceiling allocation uses)."""
        bs = self.cfg.block_size
        return (-(-(req.kv_slots + n_tokens) // bs)) - len(req.block_table)

    def _alloc_slots(self, req: Request, n_tokens: int) -> bool:
        """Grow ``req``'s block table to hold ``n_tokens`` more slots."""
        bs = self.cfg.block_size
        need = self._blocks_needed(req, n_tokens)
        if need > 0:
            got = self.blocks.allocate(need)
            if got is None:
                return False
            req.block_table.extend(got)
        req.kv_slots += n_tokens
        req.kv_allocated = len(req.block_table) * bs
        return True

    def _release_blocks(self, req: Request) -> None:
        self.blocks.free(req.block_table)
        req.block_table = []
        req.kv_slots = 0
        req.kv_allocated = 0
        self._sent_blocks.pop(req.req_id, None)   # next broadcast is full

    def _drop_from_plan(self, victim: Request, plan: StepPlan) -> int:
        """Remove ``victim``'s scheduled work from ``plan``; returns the
        token budget to refund (the victim may already hold slots in this
        very plan)."""
        refund = 0
        if victim.req_id in plan.decode:
            plan.decode.remove(victim.req_id)
            refund += 1
            victim.kv_slots -= 1
        if victim.req_id in plan.prefill_done:
            # its final chunk is rolled back below: the prompt does NOT
            # finish this step, so phase-split backends must not hand off
            plan.prefill_done.remove(victim.req_id)
        kept = []
        for entry in plan.prefill:
            if entry[0] == victim.req_id:
                refund += entry[2]
                # this chunk will never execute: roll back the progress
                # recorded when it was planned (swap preserves ``prefilled``
                # across eviction, so phantom progress would skip tokens)
                victim.prefilled -= entry[2]
                victim.kv_slots -= entry[2]
            else:
                kept.append(entry)
        plan.prefill = kept
        return refund

    def _victim_price(self, victim: Request) -> Tuple[str, float]:
        """(action, modeled cost in seconds) the active policy picks for
        evicting ``victim`` — the ONE pricing both `_choose_preemption`
        and `_eviction_cost` consult, so the victim chosen as cheapest
        is priced exactly as its eviction will be.

        Recompute prices the re-prefill of the victim's computed prompt
        tokens; tokens in blocks it has registered in the prefix cache
        are priced at zero: its blocks turn evictable, not free, so
        re-admission usually re-locks them (optimistic — sustained
        pressure can reclaim them first, docs/preemption.md).  Recompute
        also drops generated-token KV for free, the same emulation
        optimism _preempt_recompute documents.  Swap prices the
        round-trip transfer, tier-aware (docs/backends.md): a DECODING
        victim's pages live on the decode (CPU) tier under a hybrid
        backend, where the round trip is a host-local copy.  Swap is off
        the table when there is no host tier, nothing computed, or the
        host pool cannot hold the victim's blocks; the adaptive policy
        additionally demands the round trip beat recompute by
        ``swap_margin``."""
        cfg = self.cfg
        resumable = (len(victim.block_hashes) * cfg.block_size
                     if cfg.enable_prefix_cache else 0)
        recompute_cost = (max(victim.prefilled - resumable, 0)
                          * cfg.t_recompute_token)
        swap = self.blocks.swap_space
        if (cfg.preemption_policy == "recompute" or swap is None
                or not victim.block_table
                or not swap.can_hold(len(victim.block_table))):
            return "recompute", recompute_cost
        t_swap = cfg.t_swap_block
        if (victim.state == RequestState.DECODING
                and cfg.t_swap_block_decode >= 0):
            t_swap = cfg.t_swap_block_decode
        swap_cost = 2 * len(victim.block_table) * t_swap
        if cfg.preemption_policy == "swap":
            return "swap", swap_cost
        if self._swap_overloaded():
            # sustained overload: restored requests keep getting
            # re-evicted, so round trips are churn — fall back to
            # recompute until the decayed counters clear
            return "recompute", recompute_cost
        if swap_cost * cfg.swap_margin < recompute_cost:
            return "swap", swap_cost
        return "recompute", recompute_cost

    _OVERLOAD_WINDOW = 128   # steps between counter halvings

    def _swap_overloaded(self) -> bool:
        """True while the observed re-eviction rate says the swap tier is
        thrashing (adaptive policy only — see ``re_evict_threshold``)."""
        if self._n_restores < self.cfg.re_evict_min_samples:
            return False
        return (self._n_re_evicts
                > self.cfg.re_evict_threshold * self._n_restores)

    def _choose_preemption(self, victim: Request, plan: StepPlan) -> str:
        """Pick recompute vs swap for this victim (cfg.preemption_policy).

        One plan-local guard on top of `_victim_price`: a victim
        restored in this very plan cannot swap — its device pages would
        be copied out *before* the restore that fills them (backends
        apply swap_outs first)."""
        if victim.req_id in plan.restores:
            return "recompute"
        return self._victim_price(victim)[0]

    def _preempt(self, victim: Request, plan: StepPlan) -> int:
        """Evict ``victim`` under the configured policy; returns the token
        budget refund from work it already held in this plan."""
        refund = self._drop_from_plan(victim, plan)
        if victim.n_swaps > 0:
            # a previously-restored request evicted again: its swap
            # round trip(s) retired no work — overload signal for the
            # adaptive policy (``_swap_overloaded``)
            self._n_re_evicts += 1
        self.n_preempted_total += 1
        if self._choose_preemption(victim, plan) == "swap":
            self._preempt_swap(victim, plan)
        else:
            self._preempt_recompute(victim, plan)
        return refund

    def _eviction_cost(self, victim: Request) -> float:
        """Modeled seconds lost by evicting ``victim``: `_victim_price`'s
        cost, with two corrections that keep "cheapest" from
        degenerating into "evict the same request forever" (a fully
        cache-resumable victim models as free, so without them it is
        re-evicted on every allocation and its tail latency explodes):
        a floor of one block's re-prefill (the un-registered partial
        tail plus re-admission work every eviction really pays), and
        aging — each prior eviction inflates the modeled cost, so
        serial evictions rotate instead of starving one request.

        Plus a time-to-release term (``t_release_token``): a victim
        about to finish its decode would release its blocks on its own
        in ``remaining * t_release_token`` seconds of device work, so
        evicting it buys memory that was nearly free anyway — cheapest
        selection prefers victims whose remaining decode is short."""
        _, cost = self._victim_price(victim)
        floor = self.cfg.block_size * self.cfg.t_recompute_token
        hold = ((victim.max_new_tokens - len(victim.generated))
                * self.cfg.t_release_token)
        return ((max(cost, floor) + hold)
                * (1.0 + victim.n_preemptions + victim.n_swaps))

    def _pick_victim(self, req: Request) -> Request:
        """The next preemption victim.  ``lifo``: the most recently
        admitted running request.  ``cheapest``: the running request
        (other than ``req``, while any other holds blocks) whose
        eviction is cheapest under the active policy, ties broken
        toward the youngest admission — so FIFO fairness is the
        tie-break, not the rule.

        With ``cfg.slo_aware`` a class-rank term (docs/slo.md) is
        composed IN FRONT of both rules: the lowest preemption rank
        present is victimized first (best-effort before interactive),
        the original rule breaking ties within that rank.  Equal ranks —
        including the single-class and untagged cases — degenerate to
        the class-blind ordering exactly."""
        if len(self.running) == 1:
            return self.running[-1]
        if self.cfg.victim_selection == "lifo":
            if not self.cfg.slo_aware:
                return self.running[-1]
            low = min(self._victim_rank(r) for r in self.running)
            for r in reversed(self.running):
                if self._victim_rank(r) == low:
                    return r
        candidates = [r for r in self.running
                      if r is not req and r.block_table]
        if not candidates:
            return self.running[-1]
        index_of = {id(r): i for i, r in enumerate(self.running)}
        return min(candidates,
                   key=lambda r: (self._victim_rank(r),
                                  self._eviction_cost(r),
                                  -index_of[id(r)]))

    def _preempt_recompute(self, victim: Request, plan: StepPlan) -> None:
        """Preemption by recompute: drop ``victim``'s KV and requeue it at
        the head of the waiting queue.  On re-admission its prefill
        restarts at 0 but typically resumes from the prefix cache — its
        own computed blocks are evictable, not gone, until memory pressure
        actually reclaims them.  (KV of already *generated* tokens is
        dropped without re-prefill cost: a negligible emulation optimism,
        decode tails are tiny next to prompts.)"""
        if victim.req_id in plan.restores:
            # restored and re-evicted within one step: cancel the restore
            # (host blocks were already released at swap-in, so the
            # computed state is genuinely gone — full recompute)
            del plan.restores[victim.req_id]
            if victim.req_id in plan.decode_tier_swaps:
                plan.decode_tier_swaps.remove(victim.req_id)
        self._release_blocks(victim)
        victim.prefilled = 0
        victim.block_hashes = []       # recomputed blocks re-register
        victim.state = RequestState.WAITING
        victim.n_preemptions += 1
        self.running.remove(victim)
        self.waiting.insert(0, victim)
        plan.preempted.append(victim.req_id)

    def _preempt_swap(self, victim: Request, plan: StepPlan) -> None:
        """Preemption by swap: copy ``victim``'s blocks to the host tier
        (directives ride the plan; backends copy before any reuse) and
        park it on the swapped queue.  Its computed state — prefilled
        count, block hashes, generated tokens — survives; re-admission
        restores the pages instead of recomputing them.

        With the async copy engine the copy-out is IN_FLIGHT until its
        epoch retires: the source device blocks stay held (unallocatable)
        and are only freed by the transfer's completion action — so the
        backends may defer the physical copy to the epoch boundary
        without any risk of the pages being overwritten first."""
        pairs = self.blocks.swap_out(victim.req_id, victim.block_table,
                                     defer_free=self.copies is not None)
        assert pairs is not None       # _choose_preemption checked capacity
        plan.swap_outs[victim.req_id] = pairs
        if self.copies is not None:
            src_blocks = list(victim.block_table)
            self.copies.submit(
                plan.step_id, SWAP_OUT, victim.req_id, len(pairs),
                on_complete=lambda: self.blocks.finish_swap_out(src_blocks))
        self._sent_blocks.pop(victim.req_id, None)
        if victim.state == RequestState.DECODING:
            # phase tag: split-phase backends route/bill this swap-out
            # against the decode tier, matching _choose_preemption's
            # t_swap_block_decode pricing
            plan.decode_tier_swaps.append(victim.req_id)
        victim.host_block_table = [h for _, h in pairs]
        victim.block_table = []
        victim.kv_allocated = 0        # kv_slots kept: sized for swap_in
        victim.state = RequestState.SWAPPED
        victim.n_swaps += 1
        self.running.remove(victim)
        self.swapped.append(victim)

    def _allocate_with_preemption(self, req: Request, n_tokens: int,
                                  plan: StepPlan) -> Tuple[bool, int]:
        """Allocate slots for ``req``, preempting running requests (picked
        by ``cfg.victim_selection``) until it fits.  Returns
        (ok, budget_refund); ok is False when ``req`` could not be
        scheduled this step — either preempted itself, or (async copy
        engine) parked until in-flight frees land.

        Under the copy engine a swap victim's blocks free only when its
        copy-out epoch retires, so evicting it cannot satisfy THIS
        step's allocation.  Once enough deferred frees are queued to
        cover the need, stop evicting: ``req`` stays running (state
        untouched, no plan entry) and retries next step when the memory
        arrives — evicting more victims now would just cascade the
        whole batch out."""
        refund = 0
        while not self._alloc_slots(req, n_tokens):
            if self.copies is not None:
                need = self._blocks_needed(req, n_tokens)
                # every in-flight swap-out counts — this call's victims
                # (submitted by _preempt_swap) AND earlier steps' not yet
                # retired (async lookahead schedules step N+1 before
                # complete_step(N) retires; without the global view a
                # request parked at N would see its victims' blocks as
                # "not coming" and evict a fresh set every step)
                if self.copies.in_flight_blocks_of(SWAP_OUT) >= need:
                    # parked on in-flight frees: claim them next step,
                    # ahead of any swap-in (see schedule() step 0)
                    self._defer_pending = True
                    return False, refund
            victim = self._pick_victim(req)
            refund += self._preempt(victim, plan)
            if victim is req:
                return False, refund
        return True, refund

    def _finish(self, req: Request) -> None:
        req.state = RequestState.FINISHED
        self._release_blocks(req)
        self.running.remove(req)
        self.n_finished_total += 1
        self._note_done(req)

    def _finish_restore(self, req: Request) -> None:
        """Completion action of a restore transfer (async copy engine):
        the pages have landed, so the host tier drops its copy and the
        request re-enters the batch — unless the client timed out while
        the copy was in flight, in which case the target blocks are
        freed and the workers get a state-drop notice."""
        self.blocks.swap_space.release(req.req_id)
        if req.state == RequestState.TIMED_OUT:
            self._release_blocks(req)
            self._dropped_while_swapped.append(req.req_id)
            return
        self.restoring.remove(req)
        req.state = (RequestState.PREFILLING if req.prefill_remaining > 0
                     else RequestState.DECODING)
        # FRONT of running, same anti-thrash placement as the serialized
        # re-admission path
        self.running.insert(0, req)

    def _expired(self, req: Request, now: float, timeout: float) -> bool:
        """Client-timeout predicate: the request's own ``timeout`` (set
        from its SLO class, docs/slo.md) overrides the global default."""
        limit = req.timeout if req.timeout is not None else timeout
        return not req.t_first_token and now - req.t_arrival > limit

    def expire(self, now: float, timeout: float) -> List[Request]:
        """Abort requests whose client timed out (no first token within
        the request's timeout, default ``timeout``) — vLLM cancels on
        client disconnect, which bounds the queue under open-loop
        overload."""
        dead = []
        for req in list(self.waiting):
            if self._expired(req, now, timeout):
                req.state = RequestState.TIMED_OUT
                self.waiting.remove(req)
                dead.append(req)
        for req in list(self.running):
            if self._expired(req, now, timeout):
                req.state = RequestState.TIMED_OUT
                self._release_blocks(req)
                self.running.remove(req)
                dead.append(req)
        for req in list(self.swapped):
            if self._expired(req, now, timeout):
                req.state = RequestState.TIMED_OUT
                self.blocks.swap_release(req.req_id)
                req.host_block_table = []
                req.kv_slots = 0
                self.swapped.remove(req)
                # workers pinned this rid's state at swap-out; tell them to
                # drop it on the next broadcast plan
                self._dropped_while_swapped.append(req.req_id)
                dead.append(req)
        for req in list(self.restoring):
            if self._expired(req, now, timeout):
                # the restore copy is still in flight: only mark the abort
                # here — its blocks stay IN_FLIGHT until the transfer's
                # epoch retires and ``_finish_restore`` reclaims them
                req.state = RequestState.TIMED_OUT
                self.restoring.remove(req)
                dead.append(req)
        self.n_timed_out_total += len(dead)
        for req in dead:
            self._note_timeout(req)
        return dead

    # -- SLO latency classes (repro.slo, docs/slo.md) --------------------------

    def _slo_of(self, req: Request):
        """The class scheduling decisions key off — untagged requests
        behave as STANDARD (middle rank, default chunk)."""
        return req.slo if req.slo is not None else STANDARD

    def _victim_rank(self, req: Request) -> int:
        """Preemption-rank term for victim selection: lower ranks are
        evicted first.  Constant 0 when class-aware scheduling is off, so
        the composed keys degenerate to the class-blind ordering."""
        if not self.cfg.slo_aware:
            return 0
        return self._slo_of(req).rank

    def _chunk_for(self, req: Request) -> int:
        """Per-step prefill chunk for ``req``: the class's cap (if any)
        composed with the global one, so a batch prompt can't monopolize
        a step an interactive request is queued behind."""
        chunk = self.cfg.prefill_chunk
        if self.cfg.slo_aware:
            cls = self._slo_of(req)
            if cls.prefill_chunk > 0:
                chunk = min(chunk, cls.prefill_chunk)
        return chunk

    def _slack_key(self, req: Request) -> float:
        """EDF admission key: absolute TTFT deadline minus the estimated
        remaining prefill time (``t_recompute_token`` doubles as the
        per-token prefill estimate).  Smaller = more urgent; the shared
        "now" term cancels out of the ordering."""
        cls = self._slo_of(req)
        return (req.t_arrival + cls.ttft_target
                - req.prefill_remaining * self.cfg.t_recompute_token)

    def _acct_for(self, cls) -> dict:
        acct = self._slo_acct.get(cls.name)
        if acct is None:
            acct = self._slo_acct[cls.name] = {
                "rank": cls.rank, "n_first": 0, "n_ttft_ok": 0,
                "n_done": 0, "n_tpot_sample": 0, "n_tpot_ok": 0,
                "n_timeouts": 0, "slack_hist": {}}
        return acct

    def _note_first_token(self, req: Request) -> None:
        """Record a first-token event against the request's class (call
        right after ``t_first_token`` is stamped)."""
        cls = req.slo
        if cls is None:
            return
        acct = self._acct_for(cls)
        acct["n_first"] += 1
        slack = (req.t_arrival + cls.ttft_target) - req.t_first_token
        if slack >= 0:
            acct["n_ttft_ok"] += 1
        hist = acct["slack_hist"]
        b = slack_bucket(slack)
        hist[b] = hist.get(b, 0) + 1
        if cls.rank >= self.cfg.shed_min_rank:
            self._shed_samples += 1
            if slack < 0:
                self._shed_misses += 1

    def _note_done(self, req: Request) -> None:
        cls = req.slo
        if cls is None:
            return
        acct = self._acct_for(cls)
        acct["n_done"] += 1
        n_gen = len(req.generated)
        if req.t_first_token and n_gen >= 2:
            acct["n_tpot_sample"] += 1
            tpot = (req.t_done - req.t_first_token) / (n_gen - 1)
            if tpot <= cls.tpot_target:
                acct["n_tpot_ok"] += 1

    def _note_timeout(self, req: Request) -> None:
        cls = req.slo
        if cls is None:
            return
        self._acct_for(cls)["n_timeouts"] += 1
        if cls.rank >= self.cfg.shed_min_rank:
            # a protected-class request that died without a first token
            # is the hardest possible deadline miss
            self._shed_samples += 1
            self._shed_misses += 1

    def _shedding_active(self) -> bool:
        """True while protected classes (rank >= shed_min_rank) show a
        sustained TTFT-deadline miss rate — admission then deprioritizes
        lower-rank (batch-tier) work.  Counters decay with the overload
        window, so shedding self-clears once the misses stop."""
        if not self.cfg.slo_aware:
            return False
        if self._shed_samples < self.cfg.shed_min_samples:
            return False
        return (self._shed_misses
                > self.cfg.shed_miss_threshold * self._shed_samples)

    def slo_snapshot(self) -> Optional[dict]:
        """Per-class attainment counters + fractions for pressure_stats /
        the engine stats stream; None until a tagged request is seen."""
        if not self._slo_acct:
            return None
        classes = {}
        for name, acct in self._slo_acct.items():
            c = dict(acct)
            c["slack_hist"] = dict(acct["slack_hist"])
            n_first, n_tpot = c["n_first"], c["n_tpot_sample"]
            c["ttft_attainment"] = (
                c["n_ttft_ok"] / n_first if n_first else None)
            c["tpot_attainment"] = (
                c["n_tpot_ok"] / n_tpot if n_tpot else None)
            classes[name] = c
        return {"classes": classes, "shedding": self._shedding_active()}

    # -- pressure snapshot (fleet routing) -------------------------------------

    def note_cpu_saturation(self, frac: float) -> None:
        """Record the caller-measured CPU saturation (0..1) so it rides the
        next ``pressure_stats`` snapshot.  The live engine reports its
        sampler's recent saturation share; the DES reports instantaneous
        runnable/cores."""
        self.cpu_saturation = min(1.0, max(0.0, float(frac)))

    def pressure_stats(self, *,
                       with_prefix_summary: bool = False) -> PressureStats:
        """Snapshot this replica's admission/KV pressure for a fleet router.

        Every field is derived from the BlockManager and queues at call
        time.  With ``with_prefix_summary`` the snapshot carries a bloom
        summary of resident prefix-cache chain keys
        (``repro.fleet.PrefixSummary``) for cache-affinity routing."""
        if with_prefix_summary:
            raise NotImplementedError(
                "prefix summaries need the fleet router, not yet ported "
                "(ROADMAP.md, Queue 1: fleet and its frontend)")
        summary = None
        return PressureStats(
            step_id=self.step_id,
            free_blocks=self.blocks.free_blocks,
            total_blocks=self.cfg.num_kv_blocks,
            queue_depth=len(self.waiting),
            n_running=len(self.running),
            n_swapped=len(self.swapped),
            n_restoring=len(self.restoring),
            in_flight_copies=(self.copies.in_flight
                              if self.copies is not None else 0),
            kv_used_tokens=self.kv_used,
            cached_blocks=self.blocks.cached_blocks,
            n_preempted=self.n_preempted_total,
            n_timed_out=self.n_timed_out_total,
            cpu_saturation=self.cpu_saturation,
            n_finished=self.n_finished_total,
            slo=self.slo_snapshot(),
            prefix_summary=summary)

    # -- the per-step decision -------------------------------------------------

    def schedule(self) -> Optional[StepPlan]:
        """Build the next StepPlan, mutating request states."""
        self.step_id += 1
        cfg = self.cfg
        budget = cfg.max_tokens_per_step
        plan = StepPlan(self.step_id, [], [], [])
        # decay the overload counters so adaptive re-probes swap once the
        # fallback has quieted the tier (ratio alone never recovers: both
        # halve, but the sample count drops below re_evict_min_samples)
        self._overload_tick += 1
        if self._overload_tick % self._OVERLOAD_WINDOW == 0:
            self._n_restores //= 2
            self._n_re_evicts //= 2
            # shedding windows decay on the same clock, so batch-tier
            # admission is re-probed once interactive misses stop
            self._shed_samples //= 2
            self._shed_misses //= 2

        # 0. re-admit swapped requests (FIFO) ahead of ALL fresh work: their
        # computed KV is sunk transfer cost, and restoring is pure copy
        # bandwidth — it consumes device blocks but no token budget.  A
        # restored request rejoins ``running`` in its pre-swap state
        # (derived from prefill progress) and is scheduled below like any
        # other running request, after its restore directives.  Under the
        # async copy engine it instead parks in RESTORING until the
        # transfer's epoch retires (``_finish_restore``): its device
        # pages are still being filled, so nothing may read them this
        # step.  Re-admission never preempts: if the table doesn't fit,
        # it waits.
        # ... unless a compute allocation was parked last step waiting on
        # deferred frees (async mode): it claims the landed blocks first,
        # or the swapped queue would eat every freed block the moment it
        # lands and the starving decoder would evict victims forever —
        # all swap round trips, no token progress
        readmit = not self._defer_pending
        self._defer_pending = False
        while (readmit and self.swapped
               and len(self.running) + len(self.restoring)
               < cfg.max_num_seqs):
            req = self.swapped[0]
            if (self.copies is not None
                    and self.blocks.free_blocks
                    < len(req.host_block_table) + 1):
                # anti-thrash headroom (async only): the restored request
                # computes one step AFTER its restore epoch — if the
                # restore consumes the last free block, whoever needs a
                # block meanwhile evicts someone (often the restoree)
                # before that compute ever runs, and restore/evict cycles
                # forever.  The serialized path needs no headroom: its
                # restoree computes in the same plan.
                break
            pairs = self.blocks.swap_in(req.req_id,
                                        defer_release=self.copies is not None)
            if pairs is None:
                break                  # device pool full; retry next step
            self.swapped.pop(0)
            self._n_restores += 1      # overload feedback sample
            plan.restores[req.req_id] = pairs
            req.host_block_table = []
            req.block_table = [dev for _, dev in pairs]
            req.kv_allocated = len(pairs) * cfg.block_size
            if req.prefill_remaining == 0:
                # phase tag: this restore refills decode-tier pages, even
                # if the decode cap rotates the request out of this plan
                plan.decode_tier_swaps.append(req.req_id)
            if self.copies is not None:
                req.state = RequestState.RESTORING
                self.restoring.append(req)
                self.copies.submit(
                    plan.step_id, RESTORE, req.req_id, len(pairs),
                    on_complete=(lambda r=req: self._finish_restore(r)))
                continue
            req.state = (RequestState.PREFILLING if req.prefill_remaining > 0
                         else RequestState.DECODING)
            # to the FRONT of running: preemption victims are picked from
            # the tail (most recently admitted), and a restored request is
            # among the oldest admissions — parking it at the tail would
            # make it the next victim and thrash the swap tier
            self.running.insert(0, req)

        # 1. decodes first (latency priority, one token each).  Iterating a
        # snapshot: _preempt may drop later entries, whose state flips to
        # WAITING, so the state check below skips them.  When the decode
        # tier is capacity-bound (max_decode_seqs — split-phase serving,
        # docs/backends.md), only that many decode slots are scheduled per
        # step, rotating through the decoders so none starve.
        decoders = list(self.running)
        cap = cfg.max_decode_seqs
        if cap > 0:
            eligible = [r for r in decoders
                        if r.state == RequestState.DECODING]
            if len(eligible) > cap:
                start = self._decode_cursor % len(eligible)
                decoders = eligible[start:] + eligible[:start]
                decoders = decoders[:cap]
                self._decode_cursor += cap
        for req in decoders:
            if req.state != RequestState.DECODING or budget <= 0:
                continue
            ok, refund = self._allocate_with_preemption(req, 1, plan)
            budget += refund
            if not ok:
                continue
            plan.decode.append(req.req_id)
            budget -= 1

        # 2. continue chunked prefills of running requests
        for req in list(self.running):
            if req.state != RequestState.PREFILLING or budget <= 0:
                continue
            n = min(req.prefill_remaining, self._chunk_for(req), budget)
            if n > 0:
                ok, refund = self._allocate_with_preemption(req, n, plan)
                budget += refund
                if not ok:
                    continue
                plan.prefill.append((req.req_id, req.prefilled, n))
                req.prefilled += n
                budget -= n
            if req.prefill_remaining == 0:
                req.state = RequestState.DECODING
                plan.prefill_done.append(req.req_id)

        # 3. admit waiting requests while budget + slots + blocks remain.
        # Admission is optimistic (vLLM-style): it reserves blocks for the
        # next chunk only, not the whole prompt + max_new_tokens — decode
        # growth beyond capacity is handled by preemption, not head-of-line
        # blocking.  Admission itself never preempts running work.
        #
        # SLO-aware admission (docs/slo.md): when >= 2 distinct classes
        # are queued, the waiting queue is ordered by slack to each
        # request's TTFT deadline (EDF-flavored, ``_slack_key``) instead
        # of FIFO — with a single class present the order is untouched,
        # so plans stay bit-identical to the class-blind path.  While
        # protected classes show sustained deadline misses
        # (``_shedding_active``), admissions below ``shed_min_rank`` are
        # parked (skipped, not popped) whenever anything else could use
        # the step — the freed capacity goes to the missing classes, and
        # the decaying window un-parks batch once misses stop.
        bs = cfg.block_size
        if (cfg.slo_aware and len(self.waiting) > 1
                and len({self._slo_of(r).name for r in self.waiting}) > 1):
            self.waiting.sort(key=self._slack_key)
        shed = self._shedding_active()
        wi = 0
        while (wi < len(self.waiting) and budget > 0
               and len(self.running) + len(self.restoring)
               < cfg.max_num_seqs):          # RESTORING requests re-enter
                                             # running at epoch retire —
                                             # they hold batch slots too
            req = self.waiting[wi]
            if (shed and self._victim_rank(req) < cfg.shed_min_rank
                    and (self.running
                         or any(self._victim_rank(w) >= cfg.shed_min_rank
                                for w in self.waiting))):
                wi += 1                      # shed: batch-tier admission
                continue                     # parked, queue order kept
            # add_request() rejects requests that can never fit, so the head
            # of the queue always fits the pool when it runs alone
            if cfg.enable_prefix_cache:
                # lock the cached prefix (re-resolved: eviction may have
                # shrunk the probe add_request() recorded)
                hit, blks = self.blocks.lock_prefix(
                    req.prompt_tokens, max_tokens=max(req.n_prompt - 1, 0))
                req.prefilled = hit
                req.block_table = blks
                req.kv_slots = hit
                req.kv_allocated = len(blks) * bs
            n = min(req.prefill_remaining, self._chunk_for(req), budget)
            if not self._alloc_slots(req, n):
                self._release_blocks(req)      # undo prefix locks; retry later
                break
            self.waiting.pop(wi)
            self.running.append(req)
            req.state = RequestState.PREFILLING
            if n > 0:
                plan.prefill.append((req.req_id, req.prefilled, n))
                req.prefilled += n
                budget -= n
            if req.prefill_remaining == 0:
                # n == 0 only for empty prompts: straight to decode
                req.state = RequestState.DECODING
                plan.prefill_done.append(req.req_id)

        if (not plan.prefill and not plan.decode
                and not plan.swap_outs and not plan.restores
                and not self._dropped_while_swapped):
            self.step_id -= 1
            return None

        # deferred state-drop notices (aborted while swapped or while a
        # restore was in flight) ride the first plan that ships — and
        # force a notice-only plan when nothing else is left, or the
        # workers would pin the dead state forever
        if self._dropped_while_swapped:
            plan.preempted.extend(self._dropped_while_swapped)
            self._dropped_while_swapped.clear()

        # 3b. multi-step dispatch (docs/multi_step.md): when this plan is
        # steady decode — every running request is covered by this plan
        # and nothing is queued, swapped, restoring, or in flight on the
        # copy engine — extend it into a k-step macro-plan, or (taking
        # precedence, docs/spec_decode.md) a speculative verify plan.
        # Must run before step 4 so the shipped block tables include the
        # pre-reserved growth.
        if ((cfg.speculative_k > 0 or cfg.max_steps_per_dispatch > 1)
                and self._macro_eligible(plan)):
            if cfg.speculative_k > 0:
                self._extend_macro(plan, k_max=cfg.speculative_k + 1,
                                   speculative=True)
            else:
                self._extend_macro(plan)

        # 4. attach the per-request block tables + input ids the workers
        # need — the part of the payload that grows with the batch.  Under
        # delta encoding only the appended tail is serialized: tables are
        # append-only between resets and every reset path clears
        # ``_sent_blocks``, so the readers' known prefix is always valid.
        by_id = {r.req_id: r for r in self.running}
        for rid, start, n in plan.prefill:
            req = by_id[rid]
            plan.block_tables[rid] = list(req.block_table)
            plan.new_tokens[rid] = list(req.prompt_tokens[start:start + n])
        for rid in plan.decode:
            req = by_id[rid]
            plan.block_tables[rid] = list(req.block_table)
            last = (req.generated[-1] if req.generated
                    else (req.prompt_tokens[-1] if req.prompt_tokens else 0))
            plan.new_tokens[rid] = [last]
        if self.cfg.delta_block_tables:
            for rid, table in plan.block_tables.items():
                base = self._sent_blocks.get(rid, 0)
                if base:
                    plan.table_base[rid] = base
                self._sent_blocks[rid] = len(table)
        return plan

    # -- multi-step dispatch (docs/multi_step.md) -----------------------

    def _macro_eligible(self, plan: StepPlan) -> bool:
        """A plan may become a macro-plan only when the batch is
        decode-steady: the whole running set decodes this step and no
        state can change under the macro's feet — no prefill or swap
        directives in the plan, no queued/swapped/restoring requests
        that would want the next (k-1) scheduling decisions, no
        in-flight copy-engine transfer whose epoch could need servicing
        mid-macro, and no drop notices (which must ship exactly once on
        a plan the workers inspect step by step).

        ``cfg.per_tier_macros`` relaxes exactly one requirement: prefill
        chunks may ride the plan, and PREFILLING requests count as
        covered when their chunk is in it — the decode tier runs its k
        steps while the prefill tier chews the chunk (split-phase
        overlap, docs/backends.md).  A running request that got NO work
        this step still blocks extension: it is waiting on the very next
        scheduling decision."""
        if (plan.swap_outs or plan.restores
                or plan.preempted or not plan.decode):
            return False
        if plan.prefill and not self.cfg.per_tier_macros:
            return False
        if self.waiting or self.swapped or self.restoring:
            return False
        if self._defer_pending:
            return False
        if self.copies is not None and self.copies.in_flight:
            return False
        covered = set(plan.decode)
        covered.update(rid for rid, _, _ in plan.prefill)
        return all(r.req_id in covered for r in self.running)

    def _extend_macro(self, plan: StepPlan, k_max: Optional[int] = None,
                      speculative: bool = False) -> None:
        """Turn a steady-decode plan into a k-step macro-plan: reserve KV
        growth for up to ``k_max`` (default ``max_steps_per_dispatch``)
        decode iterations per request (shrinking k until the whole
        reservation fits — macro extension NEVER preempts), record
        per-request inner-step budgets capped at the remaining decode
        length, and advance ``step_id`` past the inner steps so
        copy-engine epochs stay sub-step ids.

        ``speculative=True`` marks the result a verify plan
        (docs/spec_decode.md): same reservation and budgets — a verify
        pass may emit up to its full budget b = 1 + k drafts — but the
        workers run ONE batched scoring step instead of b iterations."""
        by_id = {r.req_id: r for r in self.running}
        reqs = [by_id[rid] for rid in plan.decode]
        rem = {r.req_id: max(r.max_new_tokens - len(r.generated), 1)
               for r in reqs}
        k = min(k_max or self.cfg.max_steps_per_dispatch, max(rem.values()))
        while k > 1:
            need = sum(self._blocks_needed(r, min(k, rem[r.req_id]) - 1)
                       for r in reqs)
            if need <= self.blocks.free_blocks:
                break
            k -= 1
        if k <= 1:
            return
        for req in reqs:
            extra = min(k, rem[req.req_id]) - 1   # step 1 already allocated
            if extra > 0:
                ok = self._alloc_slots(req, extra)
                assert ok, "macro reservation was sized to fit"
        plan.num_steps = k
        plan.speculative = speculative
        plan.decode_steps = {r.req_id: min(k, rem[r.req_id]) for r in reqs}
        plan.eos_tokens = {r.req_id: r.eos_token for r in reqs
                           if r.eos_token is not None}
        self.step_id += k - 1

    def complete_step(self, plan: StepPlan, now: float,
                      result=None) -> List[Request]:
        """Account one executed step; returns newly finished requests.

        ``result`` is an optional ``repro.backend.StepResult`` whose sampled
        tokens are appended instead of the emulated placeholder 0.  For a
        macro-plan (``num_steps > 1``) the result's per-step token stream
        is consumed step by step, honoring EOS / max-len early exits; KV
        reserved for inner steps that never ran is rolled back."""
        if self.copies is not None:
            # this step's execution finished, so every transfer it (or any
            # earlier step) submitted has landed: run the deferred release
            # actions and re-admit requests whose restore epoch completed.
            # Macro-plans retire through their LAST inner step id — the
            # epochs in between belong to this plan's execution.
            self.copies.retire(plan.last_step_id)
        done = []
        tokens = result.tokens if result is not None else {}
        by_id = {r.req_id: r for r in self.running}
        if plan.num_steps > 1:
            steps = (result.token_steps
                     if result is not None
                     and getattr(result, "token_steps", None) else None)
            for rid in plan.decode:
                req = by_id.get(rid)
                if req is None:
                    continue          # aborted mid-macro: blocks already
                                      # reclaimed by expire()/abort paths
                budget = plan.decode_steps.get(rid, plan.num_steps)
                produced = 0
                hit_eos = False
                for s in range(budget):
                    if steps is None:
                        tok = 0       # cost-only execution placeholder
                    elif s < len(steps) and rid in steps[s]:
                        tok = steps[s][rid]
                    else:
                        break         # backend early-exited this row
                    req.generated.append(tok)
                    produced += 1
                    if not req.t_first_token:
                        req.t_first_token = now
                        self._note_first_token(req)
                    if len(req.generated) >= req.max_new_tokens:
                        break
                    if (req.eos_token is not None
                            and tok == req.eos_token):
                        hit_eos = True
                        break
                if produced < budget:
                    self._rollback_unused(req, budget - produced)
                if hit_eos or len(req.generated) >= req.max_new_tokens:
                    req.t_done = now
                    done.append(req)
            # per-tier macros may carry prefill chunks: account them
            # exactly like the single-step path (first token iff the
            # chunk completed the prompt)
            for rid, start, n in plan.prefill:
                req = by_id.get(rid)
                if req is None:
                    continue
                self._register_computed(req, start + n)
                if (req.state == RequestState.DECODING
                        and not req.t_first_token):
                    tok = tokens.get(rid, 0)
                    req.generated.append(tok)
                    req.t_first_token = now
                    self._note_first_token(req)
                    if (len(req.generated) >= req.max_new_tokens
                            or (req.eos_token is not None
                                and tok == req.eos_token)):
                        req.t_done = now
                        done.append(req)
            for req in done:
                self._finish(req)
            return done
        for rid in plan.decode:
            req = by_id.get(rid)
            if req is None:
                continue
            tok = tokens.get(rid, 0)
            req.generated.append(tok)
            if not req.t_first_token:
                req.t_first_token = now
                self._note_first_token(req)
            if (len(req.generated) >= req.max_new_tokens
                    or (req.eos_token is not None
                        and tok == req.eos_token)):
                req.t_done = now
                done.append(req)
        # a request whose prefill finished this step produces its first token
        for rid, start, n in plan.prefill:
            req = by_id.get(rid)
            if req is None:
                continue
            self._register_computed(req, start + n)
            if req.state == RequestState.DECODING and not req.t_first_token:
                tok = tokens.get(rid, 0)
                req.generated.append(tok)
                req.t_first_token = now
                self._note_first_token(req)
                if (len(req.generated) >= req.max_new_tokens
                        or (req.eos_token is not None
                            and tok == req.eos_token)):
                    req.t_done = now
                    done.append(req)
        for req in done:
            self._finish(req)
        return done

    def _rollback_unused(self, req: Request, n_tokens: int) -> None:
        """Return KV slots a macro-plan reserved but never wrote (EOS or
        max-len early exit).  Whole blocks freed by the shrink are
        returned to the pool; ``_sent_blocks`` is clamped so the next
        delta broadcast's known-prefix claim stays valid.  Only
        refcount-exclusive decode-tail blocks can be freed here: the
        reservation sits strictly above the prompt blocks the prefix
        cache may share."""
        req.kv_slots -= n_tokens
        bs = self.cfg.block_size
        keep = -(-req.kv_slots // bs)
        while len(req.block_table) > keep:
            self.blocks.free([req.block_table.pop()])
        req.kv_allocated = len(req.block_table) * bs
        sent = self._sent_blocks.get(req.req_id)
        if sent is not None and sent > len(req.block_table):
            self._sent_blocks[req.req_id] = len(req.block_table)

    def _register_computed(self, req: Request, n_computed: int) -> None:
        """Publish fully-computed prompt blocks to the prefix cache.  The
        chain-key memo on the request makes this O(new blocks), not
        O(total blocks), per chunk."""
        if not self.cfg.enable_prefix_cache:
            return
        bs = self.cfg.block_size
        nb = min(n_computed // bs, len(req.block_table))
        while len(req.block_hashes) < nb:
            i = len(req.block_hashes)
            prev = req.block_hashes[-1] if req.block_hashes else 0
            key = chain_key(prev, req.prompt_tokens[i * bs:(i + 1) * bs])
            req.block_hashes.append(key)
            self.blocks.register(key, req.block_table[i])

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self.swapped
                    or self.restoring or self._dropped_while_swapped)
