"""Byte-level BPE tokenizer built from scratch (the paper's §II-A① substrate).

This is the CPU-heavy component the paper characterizes: subword merging is
pure Python here (the HF tokenizer is Rust), so per-core throughput is lower,
but the *contention structure* — CPU cycles consumed on the critical path
before any accelerator work can start — is identical, and it is what the
calibrated simulator (repro.sim) scales to the paper's machines.

Encoder: classic heap-driven merge — O(n log n) in merges; regex pre-split
mirroring GPT-2's pattern so merges never cross word boundaries.

Copied from ``src/repro/tokenizer/bpe.py``, with its imports
rewritten to ``repro_torch``.
"""
from __future__ import annotations

import heapq
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# GPT-2 style pre-tokenization pattern (simplified, no lookahead on letters)
_PRETOK = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+"
)


class BPETokenizer:
    """vocab: bytes-tuple -> id; merges ranked by priority."""

    def __init__(self, merges: Sequence[Tuple[bytes, bytes]],
                 specials: Sequence[str] = ("<pad>", "<bos>", "<eos>")):
        self.specials = list(specials)
        self.merges: Dict[Tuple[bytes, bytes], int] = {
            tuple(m): i for i, m in enumerate(merges)}
        # token id space: specials, then 256 raw bytes, then merged tokens
        self.vocab: Dict[bytes, int] = {}
        nid = len(self.specials)
        for b in range(256):
            self.vocab[bytes([b])] = nid
            nid += 1
        for a, b in merges:
            self.vocab[a + b] = nid
            nid += 1
        self.id_to_bytes = {v: k for k, v in self.vocab.items()}

    @property
    def vocab_size(self) -> int:
        return len(self.specials) + len(self.vocab)

    @property
    def bos(self) -> int:
        return self.specials.index("<bos>")

    @property
    def eos(self) -> int:
        return self.specials.index("<eos>")

    # -- encoding ----------------------------------------------------------

    def _encode_word(self, word: bytes) -> List[int]:
        parts: List[bytes] = [bytes([b]) for b in word]
        if len(parts) < 2:
            return [self.vocab[p] for p in parts]
        # heap of (rank, index) candidate merges over a linked list
        nxt = list(range(1, len(parts))) + [-1]
        prv = [-1] + list(range(len(parts) - 1))
        alive = [True] * len(parts)
        heap: List[Tuple[int, int]] = []
        for i in range(len(parts) - 1):
            r = self.merges.get((parts[i], parts[i + 1]))
            if r is not None:
                heapq.heappush(heap, (r, i))
        while heap:
            r, i = heapq.heappop(heap)
            j = nxt[i]
            if not alive[i] or j == -1 or not alive[j]:
                continue
            if self.merges.get((parts[i], parts[j])) != r:
                continue  # stale entry
            parts[i] = parts[i] + parts[j]
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[j] != -1:
                prv[nxt[j]] = i
            p = prv[i]
            if p != -1 and alive[p]:
                rr = self.merges.get((parts[p], parts[i]))
                if rr is not None:
                    heapq.heappush(heap, (rr, p))
            n = nxt[i]
            if n != -1 and alive[n]:
                rr = self.merges.get((parts[i], parts[n]))
                if rr is not None:
                    heapq.heappush(heap, (rr, i))
        return [self.vocab[parts[i]] for i in range(len(parts)) if alive[i]]

    def encode(self, text: str, *, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids: List[int] = [self.bos] if add_bos else []
        for m in _PRETOK.finditer(text):
            ids.extend(self._encode_word(m.group().encode("utf-8")))
        if add_eos:
            ids.append(self.eos)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        buf = bytearray()
        for i in ids:
            if i < len(self.specials):
                continue
            buf.extend(self.id_to_bytes[i])
        return buf.decode("utf-8", errors="replace")

    # -- serialization -------------------------------------------------------

    def save(self, path: str | Path) -> None:
        merges = sorted(self.merges.items(), key=lambda kv: kv[1])
        data = {
            "specials": self.specials,
            "merges": [[a.hex(), b.hex()] for (a, b), _ in merges],
        }
        Path(path).write_text(json.dumps(data))

    @classmethod
    def load(cls, path: str | Path) -> "BPETokenizer":
        data = json.loads(Path(path).read_text())
        merges = [(bytes.fromhex(a), bytes.fromhex(b))
                  for a, b in data["merges"]]
        return cls(merges, data["specials"])


def train_bpe(corpus: Iterable[str], n_merges: int = 500,
              specials: Sequence[str] = ("<pad>", "<bos>", "<eos>")
              ) -> BPETokenizer:
    """Greedy pair-count BPE training (small vocabs; test/bench substrate)."""
    words: Dict[Tuple[bytes, ...], int] = {}
    for text in corpus:
        for m in _PRETOK.finditer(text):
            w = tuple(bytes([b]) for b in m.group().encode("utf-8"))
            if w:
                words[w] = words.get(w, 0) + 1
    merges: List[Tuple[bytes, bytes]] = []
    for _ in range(n_merges):
        counts: Dict[Tuple[bytes, bytes], int] = {}
        for w, c in words.items():
            for i in range(len(w) - 1):
                counts[(w[i], w[i + 1])] = counts.get((w[i], w[i + 1]), 0) + c
        if not counts:
            break
        best = max(counts, key=lambda k: (counts[k], k))
        if counts[best] < 2:
            break
        merges.append(best)
        new_words: Dict[Tuple[bytes, ...], int] = {}
        for w, c in words.items():
            out: List[bytes] = []
            i = 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new_words[tuple(out)] = new_words.get(tuple(out), 0) + c
        words = new_words
    return BPETokenizer(merges, specials)


_DEFAULT: Optional[BPETokenizer] = None

_SEED_CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "large language models are served on multi gpu systems",
    "tokenization consumes substantial cpu cycles on long prompts",
    "kernel launches traverse the runtime and driver stack",
    "collective communication requires all ranks to synchronize",
    "in the beginning the universe was created",
    "performance engineering is the art of measuring before changing",
    "import numpy as np and import jax for numerical computing",
    "0123456789 99 100 2048 4096 numbers and units ms us GB",
    "HTTP request handling adds CPU load through connection parsing",
]


def default_tokenizer() -> BPETokenizer:
    """Deterministic small tokenizer for benchmarks/tests."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = train_bpe(_SEED_CORPUS * 4, n_merges=400)
    return _DEFAULT
