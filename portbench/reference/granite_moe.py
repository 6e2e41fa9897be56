"""Plain reference of a decoder-only transformer with sparse experts, as
granite-moe-3b-a800m is configured here (``portbench/configs``).

Per layer: RMSNorm (eps 1e-6, the mean of squares in float32), GQA
attention with rotary positions on both halves of each head (theta from
the configuration), causal, scaled by ``1 / sqrt(head_dim)``; residual;
RMSNorm; the experts: a float32 router, softmax, the top ``k`` experts
with their probabilities renormalised to sum to one, each a SwiGLU
``silu(x W_gate) * (x W_up) W_down``, summed by gate; residual.  Then a
final RMSNorm and logits against the tied embedding.  Float32 throughout,
with TF32 off.

Capacity, as the configuration states it (``capacity_factor``): each call
of the model routes its own tokens, and an expert takes at most
``C = max(4, ceil4(floor(N * k * factor / E) + 1))`` of the ``N`` tokens
of the call; assignments beyond C are dropped, in the order of the
flattened (token, choice) list.  A served sequence is a prefill call over
all prompts, then one call per decode step over one token of every row,
so ``groups`` tells the reference which positions were routed together.

The weights are the benchmark's (``make_weights``), drawn on the device
from a seeded generator in bfloat16, and handed to the program and, drawn
again from the same seed, to this reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.numerics import matmul

EPS = 1e-6


def shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, std) of every weight, in drawing order; std 0 marks a
    norm scale, which is ones."""
    d, H, KV, Dh = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                    cfg["head_dim"])
    E, f = cfg["n_experts"], cfg["d_ff_expert"]
    out = [("embed", (cfg["padded_vocab"], d), 0.02),
           ("final_norm", (d,), 0.0)]
    for i in range(cfg["n_layers"]):
        out += [(f"l{i}.norm1", (d,), 0.0),
                (f"l{i}.wq", (d, H * Dh), d ** -0.5),
                (f"l{i}.wk", (d, KV * Dh), d ** -0.5),
                (f"l{i}.wv", (d, KV * Dh), d ** -0.5),
                (f"l{i}.wo", (H * Dh, d), (H * Dh) ** -0.5),
                (f"l{i}.norm2", (d,), 0.0),
                (f"l{i}.router", (d, E), d ** -0.5),
                (f"l{i}.w_gate", (E, d, f), d ** -0.5),
                (f"l{i}.w_up", (E, d, f), d ** -0.5),
                (f"l{i}.w_down", (E, f, d), f ** -0.5)]
    return out


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight, drawn on ``device`` from one generator seeded with
    ``seed``: one call for all the bfloat16 weights and one for the
    float32 routers, each then scaled in place; norm scales are ones."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    table = shapes(cfg)
    out: Dict[str, torch.Tensor] = {}
    for dtype, pick in ((torch.bfloat16, lambda n: not n.endswith("router")),
                        (torch.float32, lambda n: n.endswith("router"))):
        group = [(n, s, std) for n, s, std in table if pick(n) and std > 0]
        total = sum(math.prod(s) for _, s, _ in group)
        flat = torch.randn(total, generator=g, device=device, dtype=dtype)
        at = 0
        for name, shape, std in group:
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
    for name, shape, std in table:
        if std == 0:
            out[name] = torch.ones(shape, dtype=torch.bfloat16, device=device)
    return out


def _rms(x, scale):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS) * \
        scale.float()


def _rotate(x, pos, theta):
    """x [B, L, h, Dh], pos [L] -> rotary on the two halves."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, device=x.device,
                                          dtype=torch.float32) / half))
    ang = pos.float()[:, None] * freqs                        # [L, half]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def capacity(n_tokens: int, top_k: int, factor: float, n_experts: int) -> int:
    c = int(n_tokens * top_k * factor / n_experts) + 1
    return max(4, -(-c // 4) * 4)


def _kept(idx: torch.Tensor, groups: Sequence[Tuple[int, int]], B: int,
          cfg: Dict) -> torch.Tensor:
    """idx [B, L, k] -> bool [B, L, k]: which (token, choice) assignments
    their expert takes, call by call.  A group (a, b) is the positions
    a..b-1 of every row, routed in one call whose tokens are flattened
    row by row."""
    E, k = cfg["n_experts"], cfg["top_k"]
    keep = torch.zeros_like(idx, dtype=torch.bool)
    for a, b in groups:
        sub = idx[:, a:b].reshape(-1)                         # call order
        n_tok = B * (b - a)
        C = capacity(n_tok, k, cfg["capacity_factor"], E)
        onehot = F.one_hot(sub, E)                            # [N*k, E]
        rank = (onehot.cumsum(0) * onehot).sum(-1) - 1        # in expert
        keep[:, a:b] = (rank < C).view(B, b - a, k)
    return keep


def _attention(q, k, v, precision, block: int = 512):
    """Causal attention, q [B, L, H, Dh], k/v [B, L, KV, Dh] -> [B, L, H*Dh],
    over query blocks."""
    B, L, H, Dh = q.shape
    KV = k.shape[2]
    r = H // KV
    kt = k.permute(0, 2, 3, 1)[:, :, None]                    # [B,KV,1,Dh,L]
    vt = v.permute(0, 2, 1, 3)[:, :, None]                    # [B,KV,1,L,Dh]
    out = torch.empty(B, L, H * Dh, device=q.device)
    pos = torch.arange(L, device=q.device)
    for lo in range(0, L, block):
        hi = min(L, lo + block)
        qb = q[:, lo:hi].view(B, hi - lo, KV, r, Dh).permute(0, 2, 3, 1, 4)
        s = matmul(qb, kt, precision) / math.sqrt(Dh)         # [B,KV,r,q,L]
        s = s.masked_fill(pos[None, :] > pos[lo:hi, None], float("-inf"))
        o = matmul(torch.softmax(s, dim=-1), vt, precision)   # [B,KV,r,q,Dh]
        out[:, lo:hi] = o.permute(0, 3, 1, 2, 4).reshape(B, hi - lo, H * Dh)
    return out


def _experts(h, w, i, cfg, groups, precision):
    """The experts of layer ``i`` on h [B, L, d] float32."""
    B, L, d = h.shape
    probs = torch.softmax(h @ w[f"l{i}.router"].float(), dim=-1)
    gates, idx = torch.topk(probs, cfg["top_k"], dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    gates = gates * _kept(idx, groups, B, cfg)
    flat = h.reshape(B * L, d)
    y = torch.zeros_like(flat)
    idx, gates = idx.reshape(B * L, -1), gates.reshape(B * L, -1)
    for e in range(cfg["n_experts"]):
        tok, choice = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = flat[tok]
        g = matmul(x, w[f"l{i}.w_gate"][e], precision)
        u = matmul(x, w[f"l{i}.w_up"][e], precision)
        out = matmul(F.silu(g) * u, w[f"l{i}.w_down"][e], precision)
        y.index_add_(0, tok, out * gates[tok, choice, None])
    return y.view(B, L, d)


@torch.no_grad()
def logits_at(w: Dict[str, torch.Tensor], cfg: Dict, tokens: torch.Tensor,
              groups: Sequence[Tuple[int, int]], positions: Sequence[int],
              precision: str = "float32") -> torch.Tensor:
    """Logits [B, len(positions), vocab] float32 at ``positions`` of the
    token streams ``tokens`` [B, L] (each position's logits predict the
    token after it), the model run over the whole streams, layer by
    layer, with the experts' capacity taken call by call (``groups``).
    The router stays float32 whatever ``precision`` the products take."""
    B, L = tokens.shape
    H, KV, Dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    x = w["embed"][tokens.long()].float()
    pos = torch.arange(L, device=tokens.device)
    for i in range(cfg["n_layers"]):
        h = _rms(x, w[f"l{i}.norm1"])
        q = matmul(h, w[f"l{i}.wq"], precision).view(B, L, H, Dh)
        k = matmul(h, w[f"l{i}.wk"], precision).view(B, L, KV, Dh)
        v = matmul(h, w[f"l{i}.wv"], precision).view(B, L, KV, Dh)
        q = _rotate(q, pos, cfg["rope_theta"])
        k = _rotate(k, pos, cfg["rope_theta"])
        x = x + matmul(_attention(q, k, v, precision), w[f"l{i}.wo"],
                       precision)
        x = x + _experts(_rms(x, w[f"l{i}.norm2"]), w, i, cfg, groups,
                         precision)
    x = _rms(x[:, list(positions)], w["final_norm"])
    return matmul(x, w["embed"][:cfg["vocab_size"]].T, precision)
