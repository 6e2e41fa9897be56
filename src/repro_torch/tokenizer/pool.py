"""Tokenizer thread pool — the TOKENIZERS_PARALLELISM analogue.

The paper's §IV-B mechanism: the HF/Rayon tokenizer spawns parallel threads
inside the API-server process, and under concurrent requests those threads
contend with the engine/worker processes for the same CPU cores.  This pool
reproduces that structure: ``pool_width`` is our TOKENIZERS_PARALLELISM
knob, and ``measure=True`` records per-request tokenize latencies that the
calibration pass (repro.sim.calibrate) feeds into the simulator.

Copied from ``src/repro/tokenizer/pool.py``, with its imports
rewritten to ``repro_torch``.
"""
from __future__ import annotations

import concurrent.futures as cf
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch import profiling
from repro_torch.tokenizer.bpe import BPETokenizer


class TokenizerPool:
    def __init__(self, tokenizer: BPETokenizer, pool_width: int = 1,
                 measure: bool = False):
        self.tokenizer = tokenizer
        self.pool_width = max(1, pool_width)
        self.measure = measure
        self._pool = (cf.ThreadPoolExecutor(max_workers=self.pool_width,
                                            thread_name_prefix="tok")
                      if self.pool_width > 1 else None)
        self.latencies: List[Tuple[float, float, int]] = []  # (t0, dt, n_tok)
        self._lock = threading.Lock()

    def _encode_one(self, text: str) -> List[int]:
        t0 = time.perf_counter()
        prof = profiling.active()
        if prof is None:
            ids = self.tokenizer.encode(text)
        else:
            with prof.span("tokenize"):
                ids = self.tokenizer.encode(text)
        if self.measure:
            dt = time.perf_counter() - t0
            with self._lock:
                self.latencies.append((t0, dt, len(ids)))
        return ids

    def _decode_one(self, ids: Sequence[int]) -> str:
        prof = profiling.active()
        if prof is None:
            return self.tokenizer.decode(list(ids))
        with prof.span("detokenize"):
            return self.tokenizer.decode(list(ids))

    def encode(self, text: str) -> List[int]:
        return self._encode_one(text)

    def decode(self, ids: Sequence[int]) -> str:
        """Detokenize on the caller's thread (response path)."""
        return self._decode_one(ids)

    def submit_decode(self, ids: Sequence[int]) -> "cf.Future[str]":
        """Async detokenize — shares the encode threads, so response-path
        detokenization contends for the same cores (paper §IV-B)."""
        return self.submit(self._decode_one, ids)

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]:
        """Parallel batch encode (the Rayon-style fan-out)."""
        if self._pool is None or len(texts) == 1:
            return [self._encode_one(t) for t in texts]
        return list(self._pool.map(self._encode_one, texts))

    def submit(self, fn: Callable, *args) -> "cf.Future":
        """Run ``fn(*args)`` on the pool (synchronously when pool_width==1).

        The public async entry point for API-server work that must share the
        tokenizer threads (the contention the paper measures) — callers never
        touch the executor directly.
        """
        if self._pool is None:
            f: cf.Future = cf.Future()
            try:
                f.set_result(fn(*args))
            except BaseException as e:  # mirror executor future semantics
                f.set_exception(e)
            return f
        return self._pool.submit(fn, *args)

    def submit_encode(self, text: str) -> "cf.Future[List[int]]":
        """Async single-request encode (API-server request path)."""
        return self.submit(self._encode_one, text)

    def throughput_tokens_per_s(self) -> Optional[float]:
        with self._lock:
            if not self.latencies:
                return None
            toks = sum(n for _, _, n in self.latencies)
            secs = sum(dt for _, dt, _ in self.latencies)
        return toks / secs if secs > 0 else None

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
