"""Speculative decoding on the draft/verify seam (docs/spec_decode.md).

``SpeculativeBackend`` wraps two ordinary ``Backend``s behind the same
seam the engine already speaks: a **draft** child (CPU-class — the
paper's idle-cheap-cycles tier) that decodes ``k`` candidate tokens per
request with its own small model state, and a **target** child (any of
the four backends, including ``HybridBackend``) that verifies all k+1
positions in ONE batched step.  The scheduler emits the verify step as a
macro-shaped ``StepPlan`` (``speculative=True``, ``num_steps = k+1``,
per-row budgets in ``decode_steps``); this wrapper drafts worker-side,
attaches ``plan.draft_tokens``, and lets the target's ``_execute_spec``
score them.  Greedy acceptance emits the longest matching draft prefix
plus the target's correction token, so the output stream is
token-identical to sequential greedy decode on the target regardless of
draft quality — a bad draft only costs speed, never correctness.

Draft-state coherence: the draft keeps its OWN page pool (its K/V comes
from its own projections), fed with exactly the accepted token stream:

  * non-speculative plans are mirrored onto the draft (same prefill
    chunks, same swap directives, same carried tokens), so prompts and
    preemption churn keep both pools in step;
  * during drafting, ``_decode_multi`` writes the fed tokens
    ``[carried, d_1 .. d_{k-1}]`` at positions ``start..start+k-1`` —
    the accepted region of that range is *already correct* because
    acceptance means the drafts ARE the emitted stream;
  * after verification the draft's sequence length snaps to
    ``start + produced``; rejected-suffix positions fall beyond it and
    are masked/overwritten, and the one token the draft emitted but
    never fed (``d_{k-1}``, when everything was accepted) is written in
    a single fixup.

Emulated children carry no pages: drafting is skipped (the plan shape
alone prices the step) and ``synthesize_result`` models acceptance for
the DES — ``produced = 1 + round(accept_rate * (budget-1))`` per row —
which is how the reference's ``benchmarks/spec_decode.py`` sweeps the
acceptance-rate x draft-slowdown crossover without running a model.

The twin of ``src/repro/spec/__init__.py``, with its imports rewritten to
``repro_torch`` and the draft's page writes in the port's chunked
``_write([(table, start, tokens), ...])`` form.  A physical draft is
typically ``CpuDecodeBackend``: its ``_decode_multi`` is the base class's
per-step loop on the CPU, while the target verifies on the card.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.backend.base import StepResult
from repro_torch.serving.scheduler import StepPlan

__all__ = ["SpeculativeBackend"]


class SpeculativeBackend:

    def __init__(self, draft, target, *, accept_rate: Optional[float] = None):
        self.draft = draft
        self.target = target
        # DES acceptance model (emulated children / synthesize_result);
        # physical children measure acceptance instead of assuming it
        self.accept_rate = accept_rate
        self.physical = hasattr(draft, "_decode_multi")
        self.n_spec_steps = 0
        self.n_drafted = 0
        self.n_accepted = 0

    # -- plan plumbing ---------------------------------------------------

    def _draft_side(self, plan: StepPlan,
                    tables: Dict[int, List[int]]) -> StepPlan:
        """The non-decode share of ``plan`` for the draft pool: prefill
        chunks (the draft needs prompt K/V to draft from) plus swap
        directives and preemptions (so preemption churn cannot leave the
        draft reading freed pages)."""
        sp = StepPlan(plan.step_id, list(plan.prefill), [],
                      list(plan.preempted))
        for rid, _, _ in plan.prefill:
            if rid in tables:
                sp.block_tables[rid] = tables[rid]
            if rid in plan.new_tokens:
                sp.new_tokens[rid] = plan.new_tokens[rid]
        sp.swap_outs = dict(plan.swap_outs)
        sp.restores = dict(plan.restores)
        return sp

    def _draft_cost_plan(self, plan: StepPlan) -> Optional[StepPlan]:
        """The drafting work as a macro-plan on the draft device: k-1
        sequential decode iterations per row, no table re-upload (the
        draft shares the scheduler's tables in-process)."""
        if not plan.decode:
            return None
        dp = StepPlan(plan.step_id, [], list(plan.decode), [])
        dp.num_steps = max(plan.num_steps - 1, 1)
        dp.decode_steps = {
            rid: max(plan.decode_steps.get(rid, plan.num_steps) - 1, 1)
            for rid in plan.decode}
        for rid in plan.decode:
            tbl = plan.block_tables.get(rid, [])
            dp.block_tables[rid] = tbl
            dp.table_base[rid] = len(tbl)
        return dp

    # -- Backend protocol ------------------------------------------------

    def step_cost(self, plan: StepPlan) -> float:
        """Speculative steps serialize draft -> verify (verification
        cannot start before the drafts exist): the draft's k-1 step
        macro cost plus the target's batched verify cost.  Everything
        else is the target's price — the mirror writes ride the same
        idle CPU the draft does."""
        if not plan.speculative:
            return self.target.step_cost(plan)
        dp = self._draft_cost_plan(plan)
        draft_c = self.draft.step_cost(dp) if dp is not None else 0.0
        return draft_c + self.target.step_cost(plan)

    def execute(self, plan: StepPlan,
                block_tables: Optional[Dict[int, List[int]]] = None
                ) -> StepResult:
        tables = block_tables if block_tables is not None \
            else plan.block_tables
        if not self.physical:
            return self.target.execute(plan, block_tables)
        if plan.speculative:
            return self._execute_spec(plan, tables)
        res = self.target.execute(plan, block_tables)
        self._mirror(plan, tables, res)
        return res

    def _execute_spec(self, plan: StepPlan,
                      tables: Dict[int, List[int]]) -> StepResult:
        draft = self.draft
        # 1) keep the draft pool coherent: prefill chunks + swap churn
        side = self._draft_side(plan, tables)
        if (side.prefill or side.swap_outs or side.restores
                or side.preempted):
            draft.execute(side)
        # 2) draft k-1 candidates per row from the draft's own state
        rids = [rid for rid in plan.decode
                if plan.decode_steps.get(rid, plan.num_steps) > 1]
        start = {rid: draft._seq_lens.get(rid, 0) for rid in plan.decode}
        drafts: Dict[int, List[int]] = {}
        if rids:
            budgets = {rid: plan.decode_steps.get(rid, plan.num_steps) - 1
                       for rid in rids}
            steps = draft._decode_multi(
                rids, {rid: tables.get(rid, []) for rid in rids},
                {rid: start[rid] for rid in rids},
                {rid: int(plan.new_tokens.get(rid, [0])[0])
                 for rid in rids},
                budgets, {rid: plan.eos_tokens.get(rid) for rid in rids},
                max(budgets.values()))
            drafts = {rid: [row[rid] for row in steps if rid in row]
                      for rid in rids}
        plan.draft_tokens = drafts
        # 3) batched verification on the target
        res = self.target.execute(plan, tables)
        # 4) snap the draft to the accepted stream (module docstring):
        #    accepted positions already hold the right tokens; write the
        #    never-fed last draft on full acceptance, or the carried
        #    token for rows that had nothing to draft
        token_steps = res.token_steps or []
        self.n_spec_steps += 1
        for rid in plan.decode:
            b = plan.decode_steps.get(rid, plan.num_steps)
            produced = sum(1 for row in token_steps if rid in row) \
                if token_steps else b
            d = len(drafts.get(rid, ()))
            tbl = tables.get(rid, [])
            if d == 0:
                draft._write([(tbl, start[rid],
                               [int(plan.new_tokens.get(rid, [0])[0])])])
            elif produced == d + 1:
                draft._write([(tbl, start[rid] + d, [drafts[rid][-1]])])
            draft._track(rid, start[rid] + produced)
            self.n_drafted += d
            self.n_accepted += min(produced - 1, d)
        return res

    def _mirror(self, plan: StepPlan, tables: Dict[int, List[int]],
                res: StepResult) -> None:
        """Replay a non-speculative plan onto the draft pool so both
        pools see the same fed-token stream."""
        draft = self.draft
        if plan.num_steps <= 1:
            # identical plan, identical carried tokens: the draft's own
            # sampled outputs are discarded, its WRITES are the mirror
            draft.execute(plan, tables)
            return
        # defensive: a non-speculative macro-plan (the scheduler prefers
        # spec plans when speculative_k > 0, but feature flags may
        # disagree).  The draft cannot re-run the loop — its own samples
        # would feed back the WRONG tokens — so replay the fed stream
        # [carried, emitted[:-1]] from the target's result.
        side = self._draft_side(plan, tables)
        if (side.prefill or side.swap_outs or side.restores
                or side.preempted):
            draft.execute(side)
        token_steps = res.token_steps or []
        for rid in plan.decode:
            emitted = [row[rid] for row in token_steps if rid in row]
            if not emitted and res.tokens.get(rid) is not None:
                emitted = [res.tokens[rid]]
            fed = ([int(plan.new_tokens.get(rid, [0])[0])]
                   + [int(t) for t in emitted[:-1]])
            pos = draft._seq_lens.get(rid, 0)
            draft._write([(tables.get(rid, []), pos, fed)])
            draft._track(rid, pos + len(fed))

    def synthesize_result(self, plan: StepPlan) -> Optional[StepResult]:
        """DES acceptance model (emulated children only): a placeholder
        ``StepResult`` whose per-row produced count is
        ``1 + round(accept_rate * (budget-1))`` — what the scheduler's
        macro consumption needs to advance virtual time per accepted
        token.  Returns None for non-speculative plans (the caller's
        full-budget default is already right)."""
        if not plan.speculative or self.accept_rate is None:
            return None
        tokens: Dict[int, int] = {}
        steps: List[Dict[int, int]] = []
        for rid, _, _ in plan.prefill:
            tokens[rid] = 0
        for rid in plan.decode:
            b = plan.decode_steps.get(rid, plan.num_steps)
            produced = min(max(1 + int(round(self.accept_rate * (b - 1))),
                               1), b)
            for s in range(produced):
                while len(steps) <= s:
                    steps.append({})
                steps[s][rid] = 0
            tokens[rid] = 0
        return StepResult(step_id=plan.step_id, tokens=tokens,
                          wall_s=self.step_cost(plan), token_steps=steps)

    def release(self, req_id: int) -> None:
        for child in (self.draft, self.target):
            if hasattr(child, "release"):
                child.release(req_id)
