"""The Backend protocol: the seam between scheduling and execution.

The scheduler emits ``StepPlan``s; a ``Backend`` turns one plan into one
device step.  The seed hard-coded ``time.sleep(dev.step_time(plan))`` in
every consumer — the engine workers, the DES serving model, the launch
drivers — so the pallas kernels were dead code from the serving stack's
point of view.  Backends make execution a pluggable detail: any number
of implementations — cost-only emulations, real kernels, CPU paths,
composites that route sub-plans to children (heterogeneous split-phase
execution, arXiv:2504.11750) — sit behind the same two methods, and the
scheduler never knows which one is running.  The catalogue of concrete
backends and when to use each lives in docs/backends.md.

The Backend contract (what EVERY implementation must honor, whatever it
executes on; the conformance suite in tests/test_backend_conformance.py
drives each registered backend through it):

  * one ``execute(plan)`` per ``StepPlan``, in step_id order — a backend
    may keep per-request state (sequence lengths, KV pages) keyed by the
    ids in the plans, and the scheduler guarantees a request's plans
    arrive in causal order;
  * within one plan, apply directives in this order: ``swap_outs``
    (device pages -> host tier), then ``restores`` (host tier -> device
    pages), then prefill/decode compute.  A device block freed by a
    swap-out may be reallocated — even as a restore target — in the SAME
    plan, so reordering corrupts KV.  A composite backend must preserve
    this order within each child it routes directives to.  Under the
    async copy engine (``copy_streams >= 1``, docs/copy_engine.md) a
    physical backend may instead DEFER the page copies to the top of its
    next ``execute`` (the epoch boundary): the scheduler's in-flight
    holds guarantee nothing reads or reallocates the pages meanwhile,
    and same-plan reuse cannot occur — but the deferral must preserve
    submission order, and ``plan.preempted``/``release`` must drop a
    request's still-pending copies;
  * ids in ``plan.preempted`` had their KV discarded (recompute policy):
    drop any state for them.  Swapped-out requests are NOT in
    ``preempted``; their sequence state must survive until their
    restore arrives;
  * ids in ``plan.prefill_done`` finish their prompt this step, and ids
    in ``plan.decode_tier_swaps`` have decode-phase swap traffic (a
    victim evicted while DECODING, or a restore resuming decode) —
    advisory phase tags most backends ignore, but phase-splitting
    backends key their prefill->decode KV handoff and their
    swap-directive routing on them;
  * ``step_cost(plan)`` is pure (no device work, no side effects):
    virtual-time consumers (the DES) charge it instead of executing;
  * ``execute`` returns a ``StepResult`` whose ``tokens`` cover every
    decode id and every request whose prefill completed this step;
  * a macro-plan (``plan.num_steps > 1``, docs/multi_step.md) runs up to
    ``num_steps`` decode iterations device-side, feeding each sampled
    token back as the next step's input.  Row ``rid`` runs at most
    ``plan.decode_steps[rid]`` iterations and may exit early once it
    samples ``plan.eos_tokens[rid]``.  The result's ``token_steps[s]``
    maps rid -> token for every row that emitted at inner step ``s``
    (emission is prefix-contiguous: a row emits steps 0..j, then
    nothing); ``tokens`` still carries each row's LAST emitted token.
    Macro-plans are decode-steady by construction — the scheduler never
    attaches prefill, swap directives, or drop notices to one.

Conformance expectation: driving one workload through the scheduler with
any backend yields the same completion order and per-request token
counts; backends that really compute (rather than emulate cost) must
also sample identical tokens for identical plans, so execution can move
between them without changing the output stream.

Copied from ``src/repro/backend/base.py``, with its imports
rewritten to ``repro_torch``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Protocol, runtime_checkable

from repro_torch.serving.scheduler import StepPlan


class PinnedLRU:
    """Bounded per-request state map with LRU aging that spares pins.

    Backends key state by request ids, and the one-way broadcast ring
    never announces finishes — so entries refresh on ``put`` and age out
    beyond ``max_entries``, EXCEPT keys in ``pinned`` (a set shared with
    the owner — e.g. rids parked in the host swap tier), which are
    re-queued at the hot end: their state must survive arbitrary churn
    until an explicit drop.  The scan bound prevents livelock when
    everything resident is pinned.  Actives are bounded by the
    scheduler's ``max_num_seqs``, far below the cap, so live entries are
    never evicted.
    """

    def __init__(self, max_entries: int = 4096, *,
                 pinned: Optional[set] = None):
        self.max_entries = max_entries
        self.pinned = pinned if pinned is not None else set()
        self._d: "collections.OrderedDict" = collections.OrderedDict()

    def put(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        scanned = 0
        while len(self._d) > self.max_entries and scanned < self.max_entries:
            old, v = self._d.popitem(last=False)
            scanned += 1
            if old in self.pinned:
                self._d[old] = v
                self._d.move_to_end(old)

    def get(self, key, default=None):
        return self._d.get(key, default)

    def pop(self, key, default=None):
        return self._d.pop(key, default)

    def __getitem__(self, key):
        return self._d[key]

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def __repr__(self) -> str:
        return f"PinnedLRU({dict(self._d)!r})"


@dataclasses.dataclass
class StepResult:
    """What one executed step hands back to the scheduler."""
    step_id: int
    tokens: Dict[int, int] = dataclasses.field(default_factory=dict)
    # req_id -> sampled token (decode reqs + requests finishing prefill)
    wall_s: float = 0.0
    # macro-plan per-step token stream (docs/multi_step.md): entry s maps
    # req_id -> token sampled at inner step s; a row that early-exited
    # (EOS / budget) is simply absent from later entries.  None for
    # single-step plans.
    token_steps: Optional[List[Dict[int, int]]] = None


@runtime_checkable
class Backend(Protocol):
    def step_cost(self, plan: StepPlan) -> float:
        """Predicted device seconds for ``plan`` (virtual-time consumers —
        the DES — charge this instead of calling execute)."""
        ...

    def execute(self, plan: StepPlan,
                block_tables: Optional[Dict[int, List[int]]] = None
                ) -> StepResult:
        """Run one step.  ``block_tables`` overrides ``plan.block_tables``
        (they normally travel inside the plan)."""
        ...
