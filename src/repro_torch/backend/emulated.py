"""Emulated backend: the calibrated sleep that stands in for the device.

This preserves the seed's measurement methodology — everything host-side
is real, the accelerator step is a roofline-derived ``time.sleep`` — but
behind the Backend seam, and with the device model now charged for the
per-step control metadata too: uploading/consuming the block tables is
per-entry work on a real worker (per NEWLY BROADCAST entry under delta
tables), so bigger batches cost more than the three-coefficient model
admitted.  Swap/restore traffic is charged serialized or overlapped
according to the device's ``copy_streams`` (the async copy engine,
docs/copy_engine.md) — the emulated backend itself needs no deferred
copies, the whole story lives in ``DeviceModel.step_time``.

Copied from ``src/repro/backend/emulated.py``, with its imports
rewritten to ``repro_torch``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from repro_torch.backend.base import StepResult
from repro_torch.core.devmodel import DeviceModel
from repro_torch.serving.scheduler import StepPlan


class EmulatedBackend:
    def __init__(self, device: DeviceModel = DeviceModel(), *,
                 sleep: bool = True):
        self.device = device
        self.sleep = sleep          # False: account cost without wall time

    def step_cost(self, plan: StepPlan) -> float:
        return self.device.step_time(plan)

    def execute(self, plan: StepPlan,
                block_tables: Optional[Dict[int, List[int]]] = None
                ) -> StepResult:
        t = self.step_cost(plan)
        if self.sleep:
            time.sleep(t)
        # placeholder sampling: token 0 for every scheduled request (the
        # emulated device computes nothing — counts/order still exercise
        # the full control plane)
        tokens = {rid: 0 for rid in plan.decode}
        for rid, _, _ in plan.prefill:
            tokens[rid] = 0
        token_steps = None
        if plan.num_steps > 1:
            # per-step placeholder stream, honoring per-row budgets and
            # EOS (token 0 may BE a row's EOS) so the scheduler's macro
            # accounting sees the same early exits a physical backend
            # would report.  Speculative verify plans take this same
            # path at full budget (= every draft accepted); acceptance-
            # rate modeling lives in SpeculativeBackend.synthesize_result
            # for the DES (docs/spec_decode.md).
            token_steps = []
            for s in range(plan.num_steps):
                row = {rid: 0 for rid in plan.decode
                       if s < plan.decode_steps.get(rid, plan.num_steps)
                       and not (s > 0 and plan.eos_tokens.get(rid) == 0)}
                if not row:
                    break
                token_steps.append(row)
        return StepResult(step_id=plan.step_id, tokens=tokens, wall_s=t,
                          token_steps=token_steps)
