"""Request lifecycle for the serving engine (paper Fig. 1 pipeline).

Copied from ``src/repro/serving/request.py``, with its imports
rewritten to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import List, Optional

_ids = itertools.count()


class RequestState(enum.Enum):
    ARRIVED = "arrived"            # raw text in API server
    TOKENIZING = "tokenizing"
    WAITING = "waiting"            # tokenized, queued in EngineCore
    PREFILLING = "prefilling"      # chunked prefill in progress
    DECODING = "decoding"
    SWAPPED = "swapped"            # KV parked in the host tier (preempted
                                   # by swap, awaiting re-admission)
    RESTORING = "restoring"        # restore copy in flight on the async
                                   # copy engine; re-enters the batch when
                                   # its epoch completes (docs/copy_engine.md)
    FINISHED = "finished"
    TIMED_OUT = "timed_out"


@dataclasses.dataclass
class Request:
    text: str
    max_new_tokens: int = 16
    req_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    is_victim: bool = False        # attacker/victim experiment tag
    # sampling this token ends generation early (None = run to
    # max_new_tokens).  Multi-step macro-plans (docs/multi_step.md) ship
    # it to the backends so a device-side k-step loop can stop feeding a
    # finished sequence; the scheduler rolls back the unused reservation.
    eos_token: Optional[int] = None

    # SLO latency class (repro.slo, docs/slo.md).  None = untagged:
    # scheduled as STANDARD but excluded from attainment accounting.
    slo: Optional["SLOClass"] = None  # noqa: F821 - repro.slo.SLOClass
    # per-request client timeout; None = the engine/DES global default.
    # tag_request() fills it from the class's timeout.
    timeout: Optional[float] = None

    # token state
    prompt_tokens: Optional[List[int]] = None
    prefilled: int = 0             # prompt tokens already prefilled
    generated: List[int] = dataclasses.field(default_factory=list)
    kv_allocated: int = 0          # KV slots charged by the scheduler

    # paged-KV state (repro.serving.blocks)
    block_table: List[int] = dataclasses.field(default_factory=list)
    kv_slots: int = 0              # token slots occupied in block_table
    block_hashes: List[int] = dataclasses.field(default_factory=list)
    n_preemptions: int = 0         # times evicted + recomputed under pressure
    # swap-to-host state (preemption_policy swap/adaptive)
    host_block_table: List[int] = dataclasses.field(default_factory=list)
    n_swaps: int = 0               # times swapped to the host tier

    # timeline (perf_counter seconds)
    t_arrival: float = 0.0
    t_tokenize_start: float = 0.0
    t_tokenize_done: float = 0.0
    t_first_scheduled: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0

    state: RequestState = RequestState.ARRIVED

    @property
    def n_prompt(self) -> int:
        return len(self.prompt_tokens or ())

    @property
    def prefill_remaining(self) -> int:
        return self.n_prompt - self.prefilled

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token:
            return self.t_first_token - self.t_arrival
        return None

    @property
    def ttft_deadline(self) -> Optional[float]:
        """Absolute first-token deadline, if the request carries a class."""
        if self.slo is not None:
            return self.t_arrival + self.slo.ttft_target
        return None

    @property
    def tokenize_latency(self) -> Optional[float]:
        if self.t_tokenize_done:
            return self.t_tokenize_done - self.t_tokenize_start
        return None
