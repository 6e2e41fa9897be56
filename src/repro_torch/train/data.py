"""Host data pipeline: worker processes -> bounded queue -> device batches:
a copy of ``src/repro/train/data.py`` with its imports rewritten to the
port's tokenizer (the module is framework-free; batches are numpy arrays).

The training-side mirror of the paper's serving analysis: tokenization/
packing happens on dedicated worker processes so the train loop's dispatch
thread is never starved (paper §IV "training workloads" note + §V-A
dataloader remark).  Includes straggler mitigation: a per-batch deadline;
late batches are skipped and logged, not waited on.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import queue
import time
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.tokenizer.bpe import default_tokenizer

_CTX = mp.get_context("spawn")

_TEXTS = [
    "the quick brown fox jumps over the lazy dog while the engine waits",
    "multi gpu systems stall when the cpu cannot keep the devices busy",
    "tokenization lies on the critical path of every inference request",
    "collective communication requires every rank to arrive at the barrier",
    "checkpoint early checkpoint often and always restart from the latest",
    "numbers 0 1 2 3 4 5 6 7 8 9 pad the vocabulary of tiny corpora",
]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    n_workers: int = 2
    queue_depth: int = 8
    batch_deadline_s: float = 10.0     # straggler mitigation
    seed: int = 0


def _worker(cfg: DataConfig, worker_id: int, out_q, stop_ev) -> None:
    tok = default_tokenizer()
    rng = np.random.default_rng(cfg.seed + worker_id)
    while not stop_ev.is_set():
        toks: List[int] = []
        while len(toks) < cfg.batch_size * (cfg.seq_len + 1):
            text = _TEXTS[rng.integers(len(_TEXTS))]
            toks.extend(tok.encode(text, add_bos=True, add_eos=True))
        arr = np.array(toks[: cfg.batch_size * (cfg.seq_len + 1)],
                       np.int32).reshape(cfg.batch_size, cfg.seq_len + 1)
        try:
            out_q.put({"tokens": arr[:, :-1], "targets": arr[:, 1:]},
                      timeout=1.0)
        except queue.Full:
            continue


class DataPipeline:
    def __init__(self, cfg: DataConfig, vocab_size: Optional[int] = None):
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.q = _CTX.Queue(maxsize=cfg.queue_depth)
        self.stop_ev = _CTX.Event()
        self.procs: List[mp.Process] = []
        self.skipped = 0                # straggler-skipped batches

    def __enter__(self) -> "DataPipeline":
        for i in range(self.cfg.n_workers):
            p = _CTX.Process(target=_worker,
                             args=(self.cfg, i, self.q, self.stop_ev),
                             daemon=True, name=f"data-{i}")
            p.start()
            self.procs.append(p)
        return self

    def __exit__(self, *exc) -> None:
        self.stop_ev.set()
        for p in self.procs:
            p.join(timeout=2.0)
            if p.is_alive():
                p.terminate()

    def batches(self, n: int) -> Iterator[dict]:
        for _ in range(n):
            t0 = time.monotonic()
            while True:
                try:
                    b = self.q.get(timeout=0.5)
                    break
                except queue.Empty:
                    if time.monotonic() - t0 > self.cfg.batch_deadline_s:
                        # straggler mitigation: synthesize a filler batch
                        # rather than stalling the device step forever
                        self.skipped += 1
                        rng = np.random.default_rng(self.skipped)
                        arr = rng.integers(
                            0, self.vocab_size or 256,
                            (self.cfg.batch_size, self.cfg.seq_len + 1),
                            dtype=np.int32)
                        b = {"tokens": arr[:, :-1], "targets": arr[:, 1:]}
                        break
            if self.vocab_size is not None:
                b = {k: np.minimum(v, self.vocab_size - 1)
                     for k, v in b.items()}
            yield b
