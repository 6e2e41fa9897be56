"""Live multi-replica frontend: N ``ServingSystem``s behind a FleetRouter.

Each replica is a full engine stack (EngineCore process + TP workers +
shm ring); the frontend plays the fleet load balancer.  Routing keys
differ from the DES: the router hashes the prompt's leading *word*
chunks (tokenization happens asynchronously on the replica's pool, so
token-level chain keys are not available at route time), and probes only
its own optimistic dispatch summaries — the engine-published
``PressureStats`` snapshots (``EngineConfig.pressure_every``) supply the
queue/KV-pressure side of the decision.  Word-chunk keys are coarser
than block chain keys but preserve the property that matters: requests
sharing a long leading prefix hash identically and land on the replica
already holding that prefix's KV blocks.

Request ids are frontend-global; each replica numbers its own requests
from 0, so ``submit`` maps (replica, local id) -> global id and
``collect`` re-keys results on the way out.

Copied from ``src/repro/fleet/frontend.py``, with its imports rewritten to
``repro_torch``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.engine import EngineConfig, ServingSystem
from repro_torch.fleet.router import FleetRouter, RouterConfig
from repro_torch.tokenizer.bpe import BPETokenizer


def leading_word_keys(text: str, words_per_chunk: int = 16,
                      max_chunks: int = 8) -> List[int]:
    """Chain keys over the prompt's leading word chunks — the live-mode
    analogue of ``leading_block_keys`` (same chaining, coarser unit)."""
    words = text.split()
    keys: List[int] = []
    key = 0
    for i in range(0, min(len(words), words_per_chunk * max_chunks),
                   words_per_chunk):
        chunk = tuple(words[i:i + words_per_chunk])
        if len(chunk) < words_per_chunk:
            break
        key = hash((key, chunk))
        keys.append(key)
    return keys


class FleetServingFrontend:
    """Owner-side fleet: route -> submit -> collect across N replicas."""

    def __init__(self, cfgs: List[EngineConfig],
                 routing: str = "affinity",
                 tokenizer: Optional[BPETokenizer] = None,
                 router_cfg: Optional[RouterConfig] = None,
                 words_per_chunk: int = 16):
        if not cfgs:
            raise ValueError("need at least one replica config")
        self.systems = [ServingSystem(cfg, tokenizer) for cfg in cfgs]
        cfg = router_cfg or RouterConfig(policy=routing, block_size=1,
                                         queue_norm=16.0)
        self.router = FleetRouter(
            len(cfgs), cfg,
            stats_fns=[s.pressure_stats for s in self.systems])
        self.words_per_chunk = words_per_chunk
        self._next_gid = 0
        self._local_to_global: List[Dict[int, int]] = \
            [{} for _ in self.systems]
        self.results: Dict[int, dict] = {}

    @property
    def n_replicas(self) -> int:
        return len(self.systems)

    def start(self) -> "FleetServingFrontend":
        for s in self.systems:
            s.start()
        return self

    def submit(self, text: str, max_new_tokens: int = 8,
               is_victim: bool = False,
               session: Optional[object] = None,
               slo=None) -> Tuple[int, int]:
        """Route and submit; returns (global request id, replica index).
        ``slo`` (an ``repro_torch.slo.SLOClass`` or None) rides the replica's
        wire to tag the request's latency class (docs/slo.md)."""
        # word-chunk chain keys stand in for the prompt-token stream: the
        # router (block_size 1) re-chains them into probe keys, which is
        # deterministic on both the dispatch and probe side
        keys = leading_word_keys(text, self.words_per_chunk,
                                 self.router.cfg.max_probe_blocks)
        idx = self.router.route(keys, session=session)
        local = self.systems[idx].submit(text, max_new_tokens, is_victim,
                                         slo=slo)
        gid = self._next_gid
        self._next_gid += 1
        self._local_to_global[idx][local] = gid
        self.router.record_dispatch(gid, idx)
        return gid, idx

    def collect(self, n: int, timeout: float = 300.0) -> Dict[int, dict]:
        """Gather ``n`` results fleet-wide, re-keyed to global ids."""
        deadline = time.monotonic() + timeout
        while len(self.results) < n and time.monotonic() < deadline:
            progressed = False
            for idx, s in enumerate(self.systems):
                before = len(s.results)
                s.collect(before + 1, timeout=0.05)
                for local, rec in list(s.results.items()):
                    gid = self._local_to_global[idx].get(local)
                    if gid is None or gid in self.results:
                        continue
                    rec = dict(rec)
                    rec["replica"] = idx
                    rec["req_id"] = gid
                    self.results[gid] = rec
                    self.router.record_done(gid)
                    progressed = True
            if not progressed:
                time.sleep(0.01)
        return self.results

    def pressure(self) -> List[Optional[object]]:
        """Latest per-replica PressureStats (None where unpublished)."""
        return [s.pressure_stats() for s in self.systems]

    def shutdown(self, timeout: float = 30.0) -> List[List[dict]]:
        stats = []
        err: Optional[BaseException] = None
        for idx, s in enumerate(self.systems):
            for gid in self.router.drain(idx):
                self.results.setdefault(gid, {"req_id": gid,
                                              "timed_out": True,
                                              "replica": idx})
            try:
                stats.append(s.shutdown(timeout))
            except BaseException as e:     # keep tearing down the rest
                err = err or e
                stats.append([])
        if err is not None:
            raise err
        return stats
