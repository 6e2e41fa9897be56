"""Plain reference of granite-4.0-h (``granitemoehybrid``,
https://huggingface.co/ibm-granite/granite-4.0-h-small), float32, in plain
``torch`` with no kernel, cache or batching; the caller turns TF32 off on
a card.  It imports nothing of ``repro_torch`` or ``repro``.

``w`` holds the weights under the benchmark's names
(``portbench/reference/granite_4_h.shapes``); ``cfg`` the sizes under the
benchmark's keys.  The published equations, layer ``i`` a Mamba-2 or an
attention layer as ``layer_types[i]`` says:

    x = E[tokens] * embedding_multiplier
    h = RMSNorm(x);   x = x + residual_multiplier * mixer(h)
    h = RMSNorm(x);   x = x + residual_multiplier * (experts(h) + shared(h))
    logits = RMSNorm(x) E^T / logits_scaling

Mamba-2: ``[z, xBC, dt] = h W_in``; a causal conv of 4 taps with bias over
``xBC``, SiLU, cut into ``x``, ``B``, ``C``; ``dt = softplus(dt +
dt_bias)``; per head, position by position, ``s = exp(dt A) s + dt x B^T``
and ``y = s C + D x`` (``A = -exp(A_log)``); ``RMSNorm(y * silu(z))`` over
each group of channels, times its scale, then ``W_out``.  Attention: GQA,
causal, no positions (NoPE), scores scaled by ``attention_multiplier``.
Experts: top ``k`` of the router's logits, softmax over those, SwiGLU
experts weighted by their gates; the shared expert a SwiGLU with no gate.

Departures, both the program's: Mamba-2 runs as the step-by-step
recurrence above (the program runs the chunked SSD); and capacity, each
call of the model routing its own tokens (``groups``: the positions a..b-1
of every row, flattened row by row) with an expert taking at most
``max(4, ceil4(floor(N k factor / E) + 1))`` of a call's assignments, in
the order of the flattened (token, choice) list.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def mamba2(h, w, cfg):
    """h [B, L, d] -> [B, L, d], position by position."""
    B, L, _ = h.shape
    nh, hd, n, G = (cfg["ssm_heads"], cfg["ssm_head_dim"], cfg["d_state"],
                    cfg["n_groups"])
    di, K = nh * hd, cfg["d_conv"]
    proj = h @ w["w_in"]
    z, xbc, dt = proj[..., :di], proj[..., di:2 * di + 2 * G * n], \
        proj[..., 2 * di + 2 * G * n:]
    conv = torch.zeros_like(xbc)
    for t in range(L):
        for j in range(K):
            src = t - (K - 1) + j
            if src >= 0:
                conv[:, t] += xbc[:, src] * w["conv_w"][j]
    xbc = F.silu(conv + w["conv_b"])
    x = xbc[..., :di].reshape(B, L, nh, hd)
    Bg = xbc[..., di:di + G * n].reshape(B, L, G, n)
    Cg = xbc[..., di + G * n:].reshape(B, L, G, n)
    dt = F.softplus(dt + w["dt_bias"])
    A = -torch.exp(w["A_log"])
    group = [hh * G // nh for hh in range(nh)]
    s = torch.zeros(B, nh, hd, n)
    y = torch.zeros(B, L, nh, hd)
    for t in range(L):
        bt, ct = Bg[:, t, group], Cg[:, t, group]              # [B, nh, n]
        s = torch.exp(dt[:, t] * A)[..., None, None] * s + \
            (dt[:, t, :, None] * x[:, t])[..., None] * bt[:, :, None, :]
        y[:, t] = (s * ct[:, :, None, :]).sum(-1) + w["D"][:, None] * x[:, t]
    g = (y.reshape(B, L, di) * F.silu(z)).reshape(B, L, G, di // G)
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + cfg["norm_eps"])
    return (g.reshape(B, L, di) * w["ssm_norm"]) @ w["w_out"]


def attention(h, w, cfg):
    B, L, _ = h.shape
    H, KV, Dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = (h @ w["wq"]).view(B, L, H, Dh).transpose(1, 2)
    k = (h @ w["wk"]).view(B, L, KV, Dh).transpose(1, 2)
    v = (h @ w["wv"]).view(B, L, KV, Dh).transpose(1, 2)
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    s = (q @ k.transpose(-1, -2)) * cfg["attention_multiplier"]
    mask = torch.ones(L, L, dtype=torch.bool).tril()
    o = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1) @ v
    return o.transpose(1, 2).reshape(B, L, H * Dh) @ w["wo"]


def experts(h, w, cfg, groups: Sequence[Tuple[int, int]]):
    B, L, d = h.shape
    E, k = cfg["n_experts"], cfg["top_k"]
    top, idx = torch.topk(h @ w["router"], k, dim=-1)         # [B, L, k]
    gates = torch.softmax(top, dim=-1)
    out = torch.zeros(B, L, d)
    for a, b in groups:
        n_tok = B * (b - a)
        c = int(n_tok * k * cfg["capacity_factor"] / E) + 1
        cap = max(4, -(-c // 4) * 4)
        taken = [0] * E
        for r in range(B):
            for pos in range(a, b):
                for j in range(k):
                    e = int(idx[r, pos, j])
                    taken[e] += 1
                    if taken[e] > cap:
                        continue
                    out[r, pos] += gates[r, pos, j] * swiglu(
                        h[r, pos], w["w_gate"][e], w["w_up"][e],
                        w["w_down"][e])
    return out + swiglu(h, w["shared_gate"], w["shared_up"],
                        w["shared_down"])


@torch.no_grad()
def logits_at(w: Dict[str, torch.Tensor], cfg: Dict, tokens: torch.Tensor,
              groups: Sequence[Tuple[int, int]],
              positions: Sequence[int]) -> torch.Tensor:
    """Logits [B, len(positions), vocab] at ``positions`` of ``tokens``."""
    w = {k: t.float() for k, t in w.items()}
    eps, m = cfg["norm_eps"], cfg["residual_multiplier"]
    x = w["embed"][tokens.long()] * cfg["embedding_multiplier"]
    for i, kind in enumerate(cfg["layer_types"]):
        lw = {k.split(".", 1)[1]: t for k, t in w.items()
              if k.startswith(f"l{i}.")}
        h = rmsnorm(x, lw["norm1"], eps)
        x = x + m * (mamba2(h, lw, cfg) if kind == "mamba"
                     else attention(h, lw, cfg))
        x = x + m * experts(rmsnorm(x, lw["norm2"], eps), lw, cfg, groups)
    x = rmsnorm(x[:, list(positions)], w["final_norm"], eps)
    return x @ w["embed"][:cfg["vocab_size"]].T / cfg["logits_scaling"]
