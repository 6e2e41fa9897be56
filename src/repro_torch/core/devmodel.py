"""Device step-time model.

On real hardware the worker's step time comes from the accelerator; in this
container the workers *emulate* it (time.sleep) with a latency model whose
coefficients are derived from the dry-run roofline terms — so control-plane
experiments see realistic device-step durations per architecture.

compute   = t_fixed + prefill_tokens * t_prefill_tok + n_decode * t_decode_seq
          + new_block_table_entries * t_block_entry
step_time = compute + swapped_blocks * t_swap_block            (copy_streams=0)
          | swapped_blocks * t_submit_per_copy
            + max(compute, swapped_blocks * t_swap_block
                           / copy_streams)                     (copy_streams>=1)

The block-table term models the per-step metadata upload PagedAttention
adds: every *newly broadcast* entry of every scheduled request's table is
consumed by the device each step (with delta tables only the appended
tail ships, docs/copy_engine.md), so batch growth costs more than the
three-coefficient seed model admitted.  The swap term charges
host<->device KV block copies (swap-to-host preemption + restore,
docs/preemption.md): per block moved in either direction, at
interconnect bandwidth — the quantity the adaptive preemption policy
trades against recompute FLOPs.  With ``copy_streams >= 1`` those copies
ride the async copy engine (repro.core.copyengine): they drain
concurrently with compute and only the CPU submission cost plus any
un-hidden drain time surfaces in the step — degrading back to the
serialized sum as ``t_submit_per_copy`` grows (CPU starvation).

Copied from ``src/repro/core/devmodel.py``, with its imports
rewritten to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.copyengine import overlapped_seconds
from repro_torch.serving.scheduler import StepPlan


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    t_fixed: float = 2e-3           # dispatch + collective latency floor
    t_prefill_tok: float = 2e-6     # per prefill token
    t_decode_seq: float = 1e-4      # per decoding sequence
    t_block_entry: float = 2e-8     # per KV block-table entry in the plan
    t_swap_block: float = 5e-5      # per KV block copied host<->device
    max_step: float = 1.0
    # -- speculative verify (docs/spec_decode.md) --
    # a verify step scores all k+1 positions of a row in one batched
    # pass, so each position prices like a prefill token, not like a
    # sequential decode iteration; < 0 defaults to t_prefill_tok
    t_verify_tok: float = -1.0
    # -- KV precision (docs/spec_decode.md) --
    # bytes-per-element ratio of the KV pool vs fp32 (int8 -> 0.5):
    # scales every KV byte the model charges — swap/handoff block copies
    # outright, and the KV-bandwidth share of decode compute
    kv_byte_factor: float = 1.0
    kv_read_fraction: float = 0.5   # share of t_decode_seq that is KV reads
    # -- async copy engine (repro.core.copyengine, docs/copy_engine.md) --
    # 0 = serialized copies (the pre-engine model: transfers charged
    # inline); >= 1 DMA-style streams drain swap traffic concurrently
    # with compute, leaving only CPU submission + un-hidden drain time.
    copy_streams: int = 0
    t_submit_per_copy: float = 5e-6  # CPU seconds to submit one descriptor

    def step_time(self, plan: StepPlan) -> float:
        pre = sum(l for _, _, l in plan.prefill)
        # KV-bandwidth share of decode shrinks with the pool's byte
        # factor (int8 halves the bytes every decode read streams)
        dec_eff = self.t_decode_seq * (
            1.0 - self.kv_read_fraction * (1.0 - self.kv_byte_factor))
        if plan.speculative:
            # speculative verify (docs/spec_decode.md): ONE batched pass
            # scores every budgeted position, so positions price like
            # prefill tokens; the per-sequence decode overhead (KV
            # stream + sampling) is paid once, not per inner iteration
            t_verify = (self.t_verify_tok if self.t_verify_tok >= 0.0
                        else self.t_prefill_tok)
            positions = sum(plan.decode_steps.get(rid, plan.num_steps)
                            for rid in plan.decode)
            compute = (self.t_fixed + pre * self.t_prefill_tok
                       + len(plan.decode) * dec_eff
                       + positions * t_verify
                       + plan.n_new_table_entries * self.t_block_entry)
        else:
            # multi-step macro-plan (docs/multi_step.md): the dispatch /
            # collective floor and the table upload are paid ONCE per
            # broadcast — the CUDA-Graphs mechanism — while decode compute
            # scales with the total inner iterations actually budgeted
            n_decode = len(plan.decode)
            if plan.num_steps > 1:
                n_decode = sum(plan.decode_steps.get(rid, plan.num_steps)
                               for rid in plan.decode)
            compute = (self.t_fixed + pre * self.t_prefill_tok
                       + n_decode * dec_eff
                       + plan.n_new_table_entries * self.t_block_entry)
        t = overlapped_seconds(
            compute, plan.n_swapped_blocks,
            copy_streams=self.copy_streams,
            t_copy_block=self.t_swap_block * self.kv_byte_factor,
            t_submit_per_copy=self.t_submit_per_copy)
        return min(t, self.max_step * plan.num_steps)

    def preemption_calibration(self) -> dict:
        """SchedulerConfig kwargs so the adaptive preemption policy prices
        swap round-trips vs recompute with THIS device's coefficients
        (and the victim time-to-release term with its decode speed) —
        including the KV byte factor, so int8 pools price swaps at their
        actual halved bytes."""
        return {"t_swap_block": self.t_swap_block * self.kv_byte_factor,
                "t_recompute_token": self.t_prefill_tok,
                "t_release_token": self.t_decode_seq}

    def with_kv_dtype(self, kv_dtype: str) -> "DeviceModel":
        """This device with its KV pool stored at ``kv_dtype`` width."""
        return dataclasses.replace(
            self, kv_byte_factor=0.5 if kv_dtype == "int8" else 1.0)

    def copy_calibration(self) -> dict:
        """SchedulerConfig kwargs enabling the scheduler's in-flight
        transfer bookkeeping with THIS device's copy-engine shape (the
        scheduler's ``copy_streams`` must match the device's, or the
        cost model and the block-hold epochs would disagree)."""
        return {"copy_streams": self.copy_streams}

    def cpu_tier(self, *, decode_slowdown: float = 8.0,
                 prefill_slowdown: float = 40.0,
                 fixed_scale: float = 0.5,
                 swap_speedup: float = 5.0) -> "DeviceModel":
        """Heterogeneous calibration: THIS device's CPU-class sibling, for
        emulating split-phase execution (repro.backend.hybrid) with an
        ``EmulatedBackend`` pair.  The scaling story per term:

          * decode is weight/KV-bandwidth-bound, so the CPU pays the
            DDR-vs-HBM bandwidth ratio (``decode_slowdown``, ~an order of
            magnitude) — the knob benchmarks/hybrid_split.py sweeps;
          * prefill is compute-bound, where CPUs are catastrophically
            behind (``prefill_slowdown``) — which is why the hybrid
            routes prefill to the accelerator;
          * the fixed floor shrinks (``fixed_scale``): no kernel-dispatch
            or cross-device collective on the host path;
          * "swapping" KV that already lives in host DRAM is a local
            memcpy, not a PCIe trip (``swap_speedup``) — feed this into
            ``SchedulerConfig.t_swap_block_decode`` so preemption prices
            decode-tier victims at the right bandwidth.
        """
        return dataclasses.replace(
            self,
            t_fixed=self.t_fixed * fixed_scale,
            t_prefill_tok=self.t_prefill_tok * prefill_slowdown,
            t_decode_seq=self.t_decode_seq * decode_slowdown,
            t_swap_block=self.t_swap_block / swap_speedup)

    @classmethod
    def from_roofline(cls, bound_s_prefill: float, prefill_tokens: int,
                      bound_s_decode: float, decode_batch: int,
                      t_fixed: float = 2e-3) -> "DeviceModel":
        """Build from two dry-run cells (a prefill cell + a decode cell)."""
        return cls(
            t_fixed=t_fixed,
            t_prefill_tok=bound_s_prefill / max(prefill_tokens, 1),
            t_decode_seq=bound_s_decode / max(decode_batch, 1),
        )
