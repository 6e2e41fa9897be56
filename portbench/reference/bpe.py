"""A frozen copy of the serving system's tokenizer: byte-level BPE.

The benchmark counts prompt lengths in the served tokenizer's tokens and
checks that the prompt tokens a worker was handed are the tokens of the
text that was sent.  Both need the tokenizer, and the yardstick may not
import the program, so this is a copy: the GPT-2 style pre-split, the
heap-driven merge, and the small deterministic tokenizer trained on the
same seed corpus with the same number of merges.  It must keep its
behaviour while the program's tokenizer changes: a program whose
tokenizer stops giving these tokens fails the check.
"""
from __future__ import annotations

import functools
import heapq
import re
from typing import Dict, Iterable, List, Sequence, Tuple

_PRETOK = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+"
)

SEED_CORPUS = (
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
)


class Tokenizer:
    """Specials, then the 256 raw bytes, then one id per merge."""

    def __init__(self, merges: Sequence[Tuple[bytes, bytes]],
                 specials: Sequence[str] = ("<pad>", "<bos>", "<eos>")):
        self.merges: Dict[Tuple[bytes, bytes], int] = {
            tuple(m): i for i, m in enumerate(merges)}
        self.vocab: Dict[bytes, int] = {}
        nid = len(specials)
        for b in range(256):
            self.vocab[bytes([b])] = nid
            nid += 1
        for a, b in merges:
            self.vocab[a + b] = nid
            nid += 1

    def _encode_word(self, word: bytes) -> List[int]:
        parts: List[bytes] = [bytes([b]) for b in word]
        if len(parts) < 2:
            return [self.vocab[p] for p in parts]
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
                continue
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

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for m in _PRETOK.finditer(text):
            ids.extend(self._encode_word(m.group().encode("utf-8")))
        return ids


def train(corpus: Iterable[str], n_merges: int) -> Tokenizer:
    """Greedy pair-count BPE training, ties broken by the larger pair."""
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
    return Tokenizer(merges)


@functools.lru_cache(maxsize=1)
def serving_tokenizer() -> Tokenizer:
    """The tokenizer the serving engine uses by default: the seed corpus
    four times over, 400 merges."""
    return train(SEED_CORPUS * 4, n_merges=400)
