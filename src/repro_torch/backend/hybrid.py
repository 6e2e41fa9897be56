"""Split-phase execution: prefill on one backend, decode on another.

The paper's finding is that the CPU side starves accelerators — but the
same CPUs are idle, cheap compute that phase-split serving can exploit:
prefill is compute-bound and belongs on the accelerator, decode is
bandwidth-bound and latency-tolerant enough to piggyback on the CPU
while prefill saturates the device (arXiv:2504.11750, arXiv:2603.12831).
``HybridBackend`` is that split behind the ordinary ``Backend`` seam: it
owns two child backends, splits every ``StepPlan`` into a prefill
sub-plan and a decode sub-plan, executes them on their tiers, and merges
the two ``StepResult``s — the scheduler never knows.

Mechanics (each a contract obligation, see docs/backends.md):

  * **Phase routing** — ``plan.prefill`` entries go to the prefill
    (accelerator) child, ``plan.decode`` ids to the decode (CPU) child.
    Each sub-plan carries only its own block tables / input ids;
    ``plan.preempted`` fans out to BOTH children (either may hold state).
  * **KV residency** — a request's pages live with the tier that computes
    it.  The hybrid tracks residency per request; at the prefill->decode
    transition (``plan.prefill_done``, tagged by the scheduler) the
    request's pages are block-copied from the prefill child's pool into
    the decode child's pool at the SAME block ids — both children size
    their pools from the one scheduler ``BlockManager``, so ids are
    valid on either side.  The handoff *copies*, never moves: prefix
    pages registered in the scheduler's cache stay readable on the
    prefill tier for later requests that lock them.
  * **Swap routing** — ``swap_outs`` / ``restores`` go to the child that
    owns the request's KV (its residency tier); the host block ids come
    from the scheduler's single ``HostSwapSpace``, so a host block is
    only ever used by one tier at a time.  Residency survives the swap:
    a request swapped out of the decode tier restores into it.
  * **Ordering** — each child applies swap_outs -> restores -> compute
    within its sub-plan (the base contract); the two pools are disjoint
    physical memories, so cross-tier reuse of a freed block id cannot
    corrupt pages.
  * **Cost model** — ``step_cost`` is the virtual-time story: the tiers
    run concurrently, so a step costs ``max(prefill_cost, decode_cost)``
    plus ``t_handoff_block`` per page crossing at a prefill completion —
    or, with the async copy engine (``copy_streams >= 1``,
    docs/copy_engine.md), the handoff drains on a copy stream
    concurrently with both tiers and only its CPU submission cost plus
    any un-hidden drain time surfaces; physically the page copies defer
    to the next ``execute`` (the epoch boundary — the request cannot
    decode before then, so the deferred pages land before first read).
    It is pure (contract), so phases are derived from the plan itself:
    scheduled work is exact, swap victims carry the scheduler's phase
    tag (``plan.decode_tier_swaps`` — so a decode-tier victim's swap-out
    is billed at the tier whose bandwidth priced the eviction), and only
    directives with neither fall back to last-known residency.

Children may be physical (``TorchBackend``, ``CpuDecodeBackend`` — pages
really move, tokens stay identical to unified execution) or emulated
(``EmulatedBackend`` pairs with heterogeneous ``DeviceModel``s).

The twin of ``src/repro/backend/hybrid.py``, with its imports rewritten to
``repro_torch``.  The handoff crosses devices when the prefill tier runs
on the card and the decode tier on the CPU: ``export_pages`` gathers the
pages on the card, ``import_pages`` copies them to the decode tier's
device (a blocking copy, so they have landed before the decode tier
reads them) and quantizes whole pages for an int8 decode tier.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from repro_torch.backend.base import PinnedLRU, StepResult
from repro_torch.backend.emulated import EmulatedBackend
from repro_torch.core.copyengine import DeferredCopies, overlapped_seconds
from repro_torch.serving.scheduler import StepPlan

PREFILL, DECODE = "prefill", "decode"


def _sub_plan_has_work(p: StepPlan) -> bool:
    return bool(p.prefill or p.decode or p.swap_outs or p.restores)


class HybridBackend:

    def __init__(self, prefill_backend, decode_backend, *,
                 t_handoff_block: float = 5e-5, copy_streams: int = 0,
                 t_submit_per_copy: float = 5e-6):
        self.prefill_backend = prefill_backend
        self.decode_backend = decode_backend
        self.t_handoff_block = t_handoff_block
        # copy_streams >= 1: the prefill->decode handoff rides the async
        # copy engine — its cost overlaps the tiers (minus the CPU
        # submission charge) and the physical page copies defer to the
        # next execute(), the epoch boundary before the request's first
        # decode read (docs/copy_engine.md)
        self.copy_streams = copy_streams
        self.t_submit_per_copy = t_submit_per_copy
        self._deferred = DeferredCopies()
        # req_id -> tier currently holding its KV pages (base.PinnedLRU:
        # the broadcast ring never announces finishes); swapped requests
        # are pinned — their tier label must survive until the restore
        # routes their pages home.
        self._swap_pinned: set = set()
        self._tier = PinnedLRU(pinned=self._swap_pinned)
        self.n_handoffs = 0
        self.n_handoff_blocks = 0

    # -- residency -----------------------------------------------------------

    def _tier_of(self, plan: StepPlan, rid: int) -> str:
        """Tier for ``rid`` in ``plan``: scheduled work is authoritative
        (decode list -> decode tier, prefill entries -> prefill tier);
        decode-phase swap traffic — victims dropped from both lists
        before eviction, restores rotated out by the decode cap — carries
        the scheduler's phase tag (``plan.decode_tier_swaps``), so those
        copies are routed and billed against the tier that priced them
        (``t_swap_block_decode``); anything else falls back to last-known
        residency.  Pure: reads but never writes, so step_cost can share
        it."""
        if rid in plan.decode or rid in plan.decode_tier_swaps:
            return DECODE
        if any(rid == e[0] for e in plan.prefill):
            return PREFILL
        return self._tier.get(rid, PREFILL)

    def _remember(self, rid: int, tier: str) -> None:
        self._tier.put(rid, tier)

    # -- plan splitting ------------------------------------------------------

    def split_plan(self, plan: StepPlan,
                   tables: Optional[Dict[int, List[int]]] = None
                   ) -> Tuple[StepPlan, StepPlan]:
        """Split ``plan`` into (prefill sub-plan, decode sub-plan).

        Pure with respect to backend state (residency is read, not
        updated) — both ``step_cost`` and ``execute`` route through this,
        and tests drive it directly."""
        tables = tables if tables is not None else plan.block_tables
        pre = StepPlan(plan.step_id, list(plan.prefill), [],
                       list(plan.preempted))
        dec = StepPlan(plan.step_id, [], list(plan.decode),
                       list(plan.preempted))
        for rid, _, _ in plan.prefill:
            if rid in tables:
                pre.block_tables[rid] = tables[rid]
            if rid in plan.table_base:
                # keep the delta-table bases: a child's cost model bills
                # per NEWLY broadcast entry, same as the unified path
                pre.table_base[rid] = plan.table_base[rid]
            if rid in plan.new_tokens:
                pre.new_tokens[rid] = plan.new_tokens[rid]
        for rid in plan.decode:
            if rid in tables:
                dec.block_tables[rid] = tables[rid]
            if rid in plan.table_base:
                dec.table_base[rid] = plan.table_base[rid]
            if rid in plan.new_tokens:
                dec.new_tokens[rid] = plan.new_tokens[rid]
        if plan.num_steps > 1:
            # the k-step inner loop (macro or speculative verify) belongs
            # to the decode tier; under per-tier macros the prefill child
            # still chews its chunk as a plain single-step sub-plan
            dec.num_steps = plan.num_steps
            dec.decode_steps = dict(plan.decode_steps)
            dec.eos_tokens = dict(plan.eos_tokens)
            dec.speculative = plan.speculative
            dec.draft_tokens = {rid: list(t)
                                for rid, t in plan.draft_tokens.items()
                                if rid in plan.decode}
        for rid, pairs in plan.swap_outs.items():
            target = pre if self._tier_of(plan, rid) == PREFILL else dec
            target.swap_outs[rid] = pairs
        for rid, pairs in plan.restores.items():
            target = pre if self._tier_of(plan, rid) == PREFILL else dec
            target.restores[rid] = pairs
        return pre, dec

    def _handoff_blocks(self, plan: StepPlan,
                        tables: Dict[int, List[int]]) -> int:
        return sum(len(tables.get(rid, [])) for rid in plan.prefill_done)

    def _copy_handoff(self, rid: int, blocks: List[int],
                      seq_len: int) -> None:
        """Block-copy ``rid``'s pages prefill pool -> decode pool (same
        ids — one BlockManager numbers both) and move its sequence
        length.  Copy, not move: prefix pages must stay readable on the
        prefill tier for later requests that lock them.  Routed through
        export/import so a mixed-precision seam converts here: an fp32
        prefill tier hands whole pages to an int8 decode tier, which
        quantizes them single-shot with per-page scales."""
        src, dst = self.prefill_backend, self.decode_backend
        dst.import_pages(blocks, *src.export_pages(blocks))
        dst._track(rid, seq_len)

    # -- Backend protocol ----------------------------------------------------

    def step_cost(self, plan: StepPlan) -> float:
        """Concurrent tiers: max of the two sub-plan costs, plus the
        prefill->decode page handoff — serialized at interconnect cost,
        or overlapped on the copy engine's streams (only submission +
        un-hidden drain time surfaces).  Pure."""
        pre, dec = self.split_plan(plan)
        pre_c = (self.prefill_backend.step_cost(pre)
                 if _sub_plan_has_work(pre) else 0.0)
        dec_c = (self.decode_backend.step_cost(dec)
                 if _sub_plan_has_work(dec) else 0.0)
        moved = self._handoff_blocks(plan, plan.block_tables)
        return overlapped_seconds(
            max(pre_c, dec_c), moved,
            copy_streams=self.copy_streams,
            t_copy_block=self.t_handoff_block,
            t_submit_per_copy=self.t_submit_per_copy)

    def execute(self, plan: StepPlan,
                block_tables: Optional[Dict[int, List[int]]] = None
                ) -> StepResult:
        tables = block_tables if block_tables is not None \
            else plan.block_tables
        children_deferred = [
            d for d in (getattr(c, "_deferred", None)
                        for c in (self.prefill_backend, self.decode_backend))
            if d is not None]
        for rid in plan.preempted:
            self._tier.pop(rid, None)
            self._swap_pinned.discard(rid)
            # dead data: never land it late — including copies parked in
            # a child's queue, which we flush below before that child has
            # seen this plan's ``preempted``
            self._deferred.drop(rid)
            for d in children_deferred:
                d.drop(rid)
        # epoch boundary: copies deferred by earlier steps land before
        # either child computes — the CHILDREN's queues explicitly,
        # because a child whose sub-plan is empty is skipped below and
        # would otherwise sit on pending copies past their retired epoch
        # (the scheduler frees/reuses the source blocks at retire, so a
        # late flush would read another request's pages).  Cross-queue
        # order is free: every pending copy reads/writes only blocks its
        # own request still holds.
        for d in children_deferred:
            d.flush()
        # ... then the handoffs (a handed-off request decodes no earlier
        # than the step after its prefill completed, so its pages are in
        # place before the first decode-tier read)
        self._deferred.flush()
        pre, dec = self.split_plan(plan, tables)
        for rid in pre.swap_outs:
            self._swap_pinned.add(rid)
        for rid in dec.swap_outs:
            self._swap_pinned.add(rid)
        for rid in list(pre.restores) + list(dec.restores):
            self._swap_pinned.discard(rid)

        # In-process execution is serial, but the tiers it models run
        # concurrently: sleeping emulated children would charge the live
        # engine prefill + decode as a SUM, contradicting step_cost's
        # max().  Suppress their sleeps and sleep the modeled concurrent
        # wall once, below.  (Physical children really compute, so their
        # serial in-process time is interpret-mode fidelity, not a
        # latency claim — the engine ignores wall_s either way.)
        sleepers = [c for c in (self.prefill_backend, self.decode_backend)
                    if isinstance(c, EmulatedBackend) and c.sleep]
        for c in sleepers:
            c.sleep = False
        res_pre = res_dec = None
        try:
            if _sub_plan_has_work(pre) or pre.preempted:
                res_pre = self.prefill_backend.execute(pre)
            if _sub_plan_has_work(dec) or dec.preempted:
                res_dec = self.decode_backend.execute(dec)
        finally:
            for c in sleepers:
                c.sleep = True

        # record residency for work scheduled this step (after execution:
        # split/_tier_of must see the PRE-step view while routing)
        for rid, _, _ in plan.prefill:
            self._remember(rid, PREFILL)
        for rid in plan.decode:
            self._remember(rid, DECODE)

        # prefill->decode handoff: block-copy the finished request's pages
        # into the decode tier (eagerly when serialized, at the next epoch
        # boundary on the copy engine) and transfer its sequence length,
        # then forget it on the prefill side.
        moved = 0
        src, dst = self.prefill_backend, self.decode_backend
        physical = hasattr(src, "k_pages") and hasattr(dst, "k_pages")
        for rid in plan.prefill_done:
            blocks = tables.get(rid, [])
            if physical and blocks:
                if self.copy_streams > 0:
                    # async handoff: pages land at the next epoch
                    # boundary — before the request's first decode read
                    seq = src._seq_lens.get(rid, 0)
                    self._deferred.defer(
                        rid, lambda r=rid, b=list(blocks), s=seq:
                        self._copy_handoff(r, b, s))
                else:
                    self._copy_handoff(rid, blocks,
                                       src._seq_lens.get(rid, 0))
            if hasattr(src, "release"):
                src.release(rid)
            moved += len(blocks)
            self.n_handoffs += 1
            self._remember(rid, DECODE)
        self.n_handoff_blocks += moved

        tokens: Dict[int, int] = {}
        if res_pre is not None:
            tokens.update(res_pre.tokens)
        if res_dec is not None:
            tokens.update(res_dec.tokens)
        wall = overlapped_seconds(
            max(res_pre.wall_s if res_pre else 0.0,
                res_dec.wall_s if res_dec else 0.0),
            moved, copy_streams=self.copy_streams,
            t_copy_block=self.t_handoff_block,
            t_submit_per_copy=self.t_submit_per_copy)
        if sleepers:
            time.sleep(wall)       # the concurrent-tier wall, charged once
        return StepResult(step_id=plan.step_id, tokens=tokens, wall_s=wall,
                          token_steps=(res_dec.token_steps
                                       if res_dec is not None else None))

    def release(self, req_id: int) -> None:
        """Forget a finished request on both tiers."""
        for child in (self.prefill_backend, self.decode_backend):
            if hasattr(child, "release"):
                child.release(req_id)
        self._tier.pop(req_id, None)
        self._swap_pinned.discard(req_id)
        self._deferred.drop(req_id)
