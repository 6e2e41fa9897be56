"""The one traffic generator: a traffic file's parameters and a seed in,
the requests of a run out.

A traffic file (``portbench/traffic/<cell>.json``) is data.  Its ``kind``
is ``open_loop`` (requests sent on a schedule, for a serving cell) or
``batches`` (a closed loop of offline batches, for a model-path cell).

Every seed gets the same work.  The sizes and the gaps between arrivals
are one fixed multiset per traffic file, taken at evenly spaced quantiles
of the stated distributions (or, for a distribution without a closed-form
quantile, drawn once from a generator that does not depend on the seed);
the seed only orders them (``order``: with ``block_requests``, within
runs of that many requests that each carry one value of every stratum of
quantiles), pairs prompt and output lengths, and draws the words of each
text.  So two seeds differ in which request comes when, not in how much
there is to do, nor in how it spreads over the window.

Lengths are counted in the served tokenizer's tokens.  A text is made of
lowercase words joined by single spaces; each word is one pre-token of the
tokenizer, so a text's token count is the sum of its words' counts, and
the generator meets each target length exactly.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Optional, Sequence

import numpy as np

from portbench.reference.bpe import serving_tokenizer

# words of the tokenizer's seed corpus and a few more: most are one or two
# tokens, none carries a digit or a capital (one pre-token each)
WORDS = tuple(sorted(set("""
the quick brown fox jumps over lazy dog large language models are served on
multi gpu systems tokenization consumes substantial cpu cycles long prompts
kernel launches traverse runtime and driver stack collective communication
requires all ranks to synchronize in beginning universe was created
performance engineering is art of measuring before changing import numpy as
np for numerical computing numbers units request handling adds load through
connection parsing a i memory cache page block token batch step queue host
device wait time rate share limit window trace layer
""".split())))

# a fixed stream for multisets that have no closed-form quantile
_MULTISET_SEED = 0x5EED


@dataclasses.dataclass
class Request:
    """One request of a serving run: when it is due (seconds after the
    window opens), its text, its prompt length in tokens, and how many
    tokens it asks for."""
    t_due: float
    text: str
    n_prompt: int
    max_new: int


def _u64(seed: int) -> int:
    return int(seed) % (1 << 64)


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def lengths(spec: Dict, n: int) -> np.ndarray:
    """``n`` lengths of a length distribution, in ascending order, int:
    ``{"dist": "lognormal", "median", "sigma", "min", "max"}`` or
    ``{"dist": "fixed", "value"}``."""
    dist = spec["dist"]
    u = _quantiles(n)
    if dist == "fixed":
        out = np.full(n, float(spec["value"]))
    elif dist == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(x) for x in u])
        out = spec["median"] * np.exp(spec["sigma"] * z)
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    lo, hi = spec.get("min", 1), spec.get("max", math.inf)
    return np.clip(np.rint(out), lo, hi).astype(np.int64)


def gaps(spec: Dict, rate: float, n: int) -> np.ndarray:
    """``n`` gaps between arrivals with mean ``1 / rate`` seconds:
    ``{"arrival": "poisson"}`` (exponential gaps), ``"constant"``, or
    ``"gamma"`` with ``"cv"`` (a coefficient of variation above 1 makes
    bursts)."""
    kind = spec.get("arrival", "poisson")
    mean = 1.0 / rate
    if kind == "constant":
        return np.full(n, mean)
    if kind == "poisson":
        return -np.log1p(-_quantiles(n)) * mean
    if kind == "gamma":
        shape = 1.0 / spec["cv"] ** 2
        g = np.random.default_rng(_MULTISET_SEED).gamma(shape, mean / shape,
                                                        n)
        return np.sort(g)
    raise ValueError(f"unknown arrival process {kind!r}")


class TextMaker:
    """Texts of an exact token count, words drawn from a seeded stream."""

    def __init__(self, rng: np.random.Generator):
        tok = serving_tokenizer()
        self.rng = rng
        self.first = np.array([len(tok.encode(w)) for w in WORDS])
        self.rest = np.array([len(tok.encode(" " + w)) for w in WORDS])
        self.ones = [i for i, c in enumerate(self.rest) if c == 1]
        self.ones_first = [i for i, c in enumerate(self.first) if c == 1]
        if not self.ones or not self.ones_first:
            raise ValueError("the word list needs one-token words")

    def text(self, n_tokens: int, lead: str = "") -> str:
        """A text of ``n_tokens`` tokens after ``lead`` (whose own tokens
        are not counted); ``lead`` is a whole text, or empty."""
        words: List[str] = []
        left = n_tokens
        first = not lead
        while left > 0:
            counts = self.first if first else self.rest
            if left > 3:
                i = int(self.rng.integers(len(WORDS)))
            else:
                # close on one-token words so the count lands exactly
                pool = self.ones_first if first else self.ones
                i = pool[int(self.rng.integers(len(pool)))]
            c = int(counts[i])
            if c > left:
                continue
            words.append(WORDS[i])
            left -= c
            first = False
        body = " ".join(words)
        return f"{lead} {body}" if lead else body


def open_loop(spec: Dict, seed: int, seconds: float) -> List[Request]:
    """The requests due in a window of ``seconds``, open loop at
    ``spec["rate_rps"]``, in order of their due times."""
    n = max(1, int(round(spec["rate_rps"] * seconds)))
    return _requests(spec, n, np.random.default_rng([_u64(seed), 1]),
                     spec["rate_rps"])


def warmup(spec: Dict, seed: int) -> List[Request]:
    """The warm-up requests: ``warmup_s`` seconds of the window's own
    traffic (same distributions and rate, other texts and order)."""
    n = max(1, int(round(spec["rate_rps"] * spec["warmup_s"])))
    return _requests(spec, n, np.random.default_rng([_u64(seed), 2]),
                     spec["rate_rps"])


def order(values: np.ndarray, rng: np.random.Generator,
          block: int) -> np.ndarray:
    """``values`` in the order a seed gives them.  With ``block`` > 1 the
    order is stratified: the sorted values are cut into ``block`` strata
    of consecutive quantiles, each run of ``block`` requests takes one
    value from every stratum (which one, the seed draws), and the seed
    shuffles each run.  So every stretch of ``block`` requests carries
    nearly the same work, whatever the seed; the seed still decides what
    comes when within it."""
    n = len(values)
    if block <= 1 or n < 2 * block:
        return rng.permutation(values)
    v = np.sort(values)
    m = n // block                      # runs of ``block``; the rest last
    strata = v[:m * block].reshape(block, m)
    runs = np.stack([rng.permutation(row) for row in strata], axis=1)
    runs = np.stack([rng.permutation(r) for r in runs])
    return np.concatenate([runs.reshape(-1),
                           rng.permutation(v[m * block:])])


def _requests(spec: Dict, n: int, rng: np.random.Generator,
              rate: Optional[float]) -> List[Request]:
    block = int(spec.get("block_requests", 0))
    prompt = order(lengths(spec["prompt_tokens"], n), rng, block)
    out = order(lengths(spec["output_tokens"], n), rng, block)
    due = (np.cumsum(order(gaps(spec, rate, n), rng, block))
           if rate else np.zeros(n))
    maker = TextMaker(rng)
    prefix = spec.get("shared_prefix")
    leads: Sequence[str] = ()
    if prefix:
        # each request leads with one of ``groups`` fixed prefix texts
        leads = [maker.text(int(prefix["tokens"]))
                 for _ in range(int(prefix["groups"]))]
    reqs = []
    for i in range(n):
        lead = leads[i % len(leads)] if leads else ""
        n_lead = int(prefix["tokens"]) if lead else 0
        body = max(int(prompt[i]) - n_lead, 1)
        reqs.append(Request(float(due[i]), maker.text(body, lead),
                            n_lead + body, int(out[i])))
    return reqs


def batch_tokens(spec: Dict, seed: int, index: int, vocab: int, device):
    """Batch ``index`` of a ``batches`` traffic: ``rows`` prompts of
    ``prompt_tokens`` token ids below ``vocab``, int32 on ``device``, drawn
    from a generator on that device seeded from (seed, index)."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed((_u64(seed) * 1_000_003 + index) % (1 << 63))
    return torch.randint(0, vocab, (spec["rows"], spec["prompt_tokens"]),
                         generator=g, device=device, dtype=torch.int32)
