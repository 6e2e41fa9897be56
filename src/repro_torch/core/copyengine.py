"""Async copy engine: CPU-gated overlapped KV transfers (docs/copy_engine.md).

The paper's core phenomenon is that host work — not accelerator work —
sets the pace of multi-GPU serving.  Until this subsystem existed the
stack reproduced that only for *launches*: every KV transfer (swap-out,
restore, prefill->decode handoff) serialized into the device step it
rode on (``DeviceModel.step_time`` charged ``t_swap_block`` inline, the
hybrid added the handoff on top of ``max(children)``).  Real engines
instead enqueue such copies on DMA-style **copy streams** that drain
concurrently with compute — but *submitting* each descriptor is CPU
work, so the overlap itself is CPU-gated: with ample cores transfers
hide behind compute, and under CPU starvation submission serializes and
the "async" engine degrades back to today's inline behavior.  That
degradation is the phenomenon, made first-class.

Two cooperating halves, sharing one epoch contract:

* ``CopyEngine`` — pure bookkeeping owned by the *scheduler*: every
  enqueued transfer gets a **completion epoch** (the step id that
  submitted it; the step's cost model stretches the step until its
  copies have drained, so the epoch completes when that step's execution
  completes).  Resources a transfer reads or writes stay **IN_FLIGHT**
  until the epoch retires: a swap-out's source device blocks are not
  freed (so same-plan reuse — the old serialized contract's hard case —
  cannot happen), a restore's host blocks stay owned, and a restored
  request re-enters the batch only after its restore epoch completes
  (``RequestState.RESTORING``).  ``retire(step_id)`` runs the deferred
  release actions.

* ``DeferredCopies`` — the physical half, owned by the page-pool
  backends: directives are *recorded* at submission and the page copies
  **applied at the next ``execute`` call** (the epoch boundary).  The
  scheduler's in-flight holds guarantee no reader or writer races the
  deferred copy, so bit-identity with the serialized path is preserved
  — the conformance suite pins this over ``copy_streams`` in {0, 1, 2}.

The cost model both emulated consumers charge (``DeviceModel``,
``HybridBackend``) is ``overlapped_seconds``::

    serialized (streams == 0):  compute + n_blocks * t_copy_block
    overlapped (streams >= 1):  n_blocks * t_submit_per_copy
                                + max(compute, n_blocks * t_copy_block
                                               / streams)

Submission is charged inline — a CPU thread must write every descriptor
before the DMA can start, which is exactly how scarce/slow CPUs erode
the overlap: as ``t_submit_per_copy`` grows (fewer cores, contended
cores), the overlapped cost approaches and then exceeds the serialized
one.  ``benchmarks/copy_overlap.py`` sweeps that degradation.

Copied from ``src/repro/core/copyengine.py``, with its imports
rewritten to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch import profiling

SWAP_OUT, RESTORE, HANDOFF = "swap_out", "restore", "handoff"


def overlapped_seconds(compute_s: float, n_blocks: int, *,
                       copy_streams: int, t_copy_block: float,
                       t_submit_per_copy: float) -> float:
    """Step seconds for ``compute_s`` of device work plus ``n_blocks`` of
    copy traffic under the stream model above.  Pure — safe for
    ``Backend.step_cost``."""
    if n_blocks <= 0:
        return compute_s
    if copy_streams <= 0:                      # serialized: the pre-engine path
        return compute_s + n_blocks * t_copy_block
    submit = n_blocks * t_submit_per_copy
    drain = n_blocks * t_copy_block / copy_streams
    return submit + max(compute_s, drain)


@dataclasses.dataclass
class Transfer:
    """One in-flight block transfer, keyed by its completion epoch."""
    step_id: int                   # submission step == completion epoch
    kind: str                      # SWAP_OUT | RESTORE | HANDOFF
    req_id: int
    n_blocks: int
    on_complete: Optional[Callable[[], None]] = None


class CopyEngine:
    """Completion-epoch bookkeeping for in-flight transfers.

    Owned by the scheduler (one instance when ``copy_streams > 0``).
    ``submit`` records a transfer against the submitting step;
    ``retire(step_id)`` completes every transfer whose epoch has passed
    and runs its deferred release action (free the swap-out's device
    blocks, re-admit the restored request, ...).  Epochs are step ids,
    not wall clock: the step-cost contract stretches a step until its
    copies drain, so "step N executed" implies "step N's copies landed"
    in both the live engine and the DES.  Retirement is idempotent and
    ordered — transfers retire in submission order, which is also the
    order ``DeferredCopies`` applies the physical pages.
    """

    def __init__(self, copy_streams: int = 1):
        assert copy_streams >= 1, "0 streams means: no engine at all"
        self.copy_streams = copy_streams
        self._inflight: List[Transfer] = []    # submission order
        self.n_submitted = 0
        self.n_retired = 0

    def submit(self, step_id: int, kind: str, req_id: int, n_blocks: int,
               on_complete: Optional[Callable[[], None]] = None) -> Transfer:
        profiling.hit("copy_submit", step=step_id, req=req_id)
        t = Transfer(step_id, kind, req_id, n_blocks, on_complete)
        self._inflight.append(t)
        self.n_submitted += 1
        return t

    def retire(self, step_id: int) -> List[Transfer]:
        """Complete every transfer submitted at or before ``step_id``
        (that step's execution finished, so its copies have landed)."""
        done = [t for t in self._inflight if t.step_id <= step_id]
        if done:
            self._inflight = [t for t in self._inflight
                              if t.step_id > step_id]
            for t in done:
                self.n_retired += 1
                if t.on_complete is not None:
                    t.on_complete()
        return done

    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    @property
    def in_flight_blocks(self) -> int:
        return sum(t.n_blocks for t in self._inflight)

    def in_flight_blocks_of(self, kind: str) -> int:
        """Blocks of in-flight transfers of one kind — e.g. SWAP_OUT
        gives the device blocks that will free at upcoming retires (the
        scheduler's parked allocations count these as arriving memory)."""
        return sum(t.n_blocks for t in self._inflight if t.kind == kind)


class DeferredCopies:
    """FIFO of deferred physical page copies for the paged backends.

    ``defer(req_id, fn)`` records a copy at submission; ``flush()`` —
    called at the top of the *next* ``execute`` — applies everything
    recorded so far, in submission order (which preserves the
    swap_outs -> restores directive order within each source plan).
    ``drop(req_id)`` discards a request's pending copies without
    applying them: its state was dropped (``plan.preempted`` /
    ``release``), so the data is dead and landing it late could only
    dirty pages another request now owns.
    """

    def __init__(self):
        self._pending: List[Tuple[int, Callable[[], None]]] = []

    def defer(self, req_id: int, fn: Callable[[], None]) -> None:
        self._pending.append((req_id, fn))

    def flush(self) -> int:
        pending, self._pending = self._pending, []
        for _, fn in pending:
            fn()
        return len(pending)

    def drop(self, req_id: int) -> None:
        self._pending = [(r, fn) for r, fn in self._pending if r != req_id]

    def __len__(self) -> int:
        return len(self._pending)
