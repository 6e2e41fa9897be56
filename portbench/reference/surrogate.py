"""Plain reference of the serving surrogate: one attention layer over a
paged cache, then the output projection to the vocabulary, greedy.

The serving leaf embeds each token, projects it to K and V, which it
stores at the token's position, and at each sampled position projects the
last token to a query, attends over every stored position up to it, and
multiplies the attention output by ``wo`` to get the logits.  Here that is
computed over a request's whole token stream at once, with no pages and no
kernel: a causal attention whose queries are the positions where a token
was sampled.

The weights are the serving leaf's, drawn by a frozen copy of its rule
(numpy's ``default_rng(seed)``, standard normals in the order embed, wq,
wk, wv, wo, the projections scaled by ``1 / sqrt(n_heads * head_dim)``),
so the reference makes its own and takes none from the program.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from portbench.reference.numerics import matmul


def draw_params(*, vocab: int, n_heads: int, n_kv_heads: int, head_dim: int,
                seed: int) -> Dict[str, np.ndarray]:
    embed_dim = n_heads * head_dim
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(embed_dim)
    embed = rng.standard_normal((vocab, embed_dim)).astype(np.float32)
    wq = (rng.standard_normal(
        (embed_dim, n_heads * head_dim)) * scale).astype(np.float32)
    wk = (rng.standard_normal(
        (embed_dim, n_kv_heads * head_dim)) * scale).astype(np.float32)
    wv = (rng.standard_normal(
        (embed_dim, n_kv_heads * head_dim)) * scale).astype(np.float32)
    wo = (rng.standard_normal((embed_dim, vocab)) * scale).astype(np.float32)
    return {"embed": embed, "wq": wq, "wk": wk, "wv": wv, "wo": wo}


class Surrogate:
    """The surrogate at given widths, its weights on ``device``."""

    def __init__(self, widths: Dict, seed: int, device):
        self.h = widths["n_heads"]
        self.kv = widths["n_kv_heads"]
        self.d = widths["head_dim"]
        self.vocab = widths["vocab"]
        arrays = draw_params(vocab=self.vocab, n_heads=self.h,
                             n_kv_heads=self.kv, head_dim=self.d, seed=seed)
        self.w = {k: torch.from_numpy(v).to(device) for k, v in
                  arrays.items()}
        self.device = torch.device(device)

    def logits(self, tokens: Sequence[int], lengths: Sequence[int],
               precision: str = "float32", block: int = 256
               ) -> torch.Tensor:
        """Logits [n, vocab] float32 of the ``n`` samples taken over the
        stream ``tokens`` after ``lengths[j]`` of its tokens were stored:
        sample j's query is token ``lengths[j] - 1`` and it attends over
        positions ``0 .. lengths[j] - 1``."""
        w, H, KV, D = self.w, self.h, self.kv, self.d
        tok = torch.as_tensor(np.asarray(tokens, np.int64),
                              device=self.device) % self.vocab
        ln = torch.as_tensor(np.asarray(lengths, np.int64),
                             device=self.device)
        e = w["embed"][tok]                                     # [L, E]
        k = matmul(e, w["wk"], precision).view(-1, KV, D)
        v = matmul(e, w["wv"], precision).view(-1, KV, D)
        pos = torch.arange(tok.shape[0], device=self.device)
        out = []
        for lo in range(0, ln.shape[0], block):
            lj = ln[lo:lo + block]
            q = matmul(e[lj - 1], w["wq"], precision).view(-1, KV, H // KV, D)
            s = matmul(q, k.permute(1, 2, 0)[None], precision) / D ** 0.5
            s = s.masked_fill((pos[None, :] >= lj[:, None])[:, None, None],
                              float("-inf"))
            a = torch.softmax(s, dim=-1)                      # [n, KV, r, L]
            o = matmul(a, v.permute(1, 0, 2)[None], precision)  # [n, KV, r, D]
            out.append(matmul(o.reshape(o.shape[0], H * D), w["wo"],
                              precision))
        return torch.cat(out)
