"""Plain reference of DeepSeek-V2 (``deepseek_v2``,
https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite), float32, in plain
``torch`` with no kernel, cache or batching; the caller turns TF32 off on
a card.  It imports nothing of ``repro_torch`` or ``repro``.

``w`` holds the weights under the benchmark's names
(``portbench/reference/deepseek_v2.shapes``), in the published layouts
(``[d_in, d_out]``, each head's columns together, rotary channels in
pairs); ``cfg`` the sizes under the benchmark's keys.  The published
equations (the DeepSeek-V2 paper, the model's ``modeling_deepseek.py``):

    x = E[tokens]
    layer i:  x = x + MLA(RMSNorm(x));  x = x + FFN_i(RMSNorm(x))
    logits = RMSNorm(x) W_head^T

MLA, decompressed, with no compression of q: ``q = h W_q`` per head
``[q_nope (Dn), q_pe (Dr)]``; ``[c_kv, k_pe] = h W_kv_a``, ``c_kv =
RMSNorm(c_kv)``; ``[k_nope, v] = c_kv W_kv_b`` per head; ``q_pe`` and the
one ``k_pe`` every head shares rotated: channels (2i, 2i + 1) are first
regrouped as halves, then ``x cos + rotate_half(x) sin`` at YaRN's
frequencies, cos and sin times ``mscale(factor, mscale) / mscale(factor,
mscale_all_dim)``; causal softmax of ``(q_nope . k_nope + q_pe . k_pe)
scale`` with ``scale = (Dn + Dr)^-1/2 mscale(factor, mscale_all_dim)^2``;
``o v``, then ``W_o``.  FFN: layers below ``first_k_dense_replace`` a
SwiGLU ``silu(h W_gate) * (h W_up) W_down``; the others the softmax of the
router's logits over all experts, the top ``k`` probabilities as the
gates (over their sum only where ``renormalize``, ``norm_topk_prob``, is
set: DeepSeek-V2-Lite's is not; ``routed_scaling_factor`` 1), each chosen
expert a SwiGLU weighted by its gate, plus the shared experts, one SwiGLU
with no gate.

The one departure is the program's: capacity, each call of the model
routing its own tokens (``groups``: the positions a..b-1 of every row,
flattened row by row), an expert taking at most ``max(4, ceil4(floor(N k
factor / E) + 1))`` of a call's assignments in the order of the flattened
(token, choice) list.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def yarn_get_mscale(scale, mscale):
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg):
    """The published ``DeepseekV2YarnRotaryEmbedding``'s frequencies."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    ys = cfg["rope_scaling"]
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2).float() / dim))
    freq_inter = 1.0 / (ys["factor"]
                        * base ** (torch.arange(0, dim, 2).float() / dim))

    def corr(rot):
        return (dim * math.log(ys["original_max_position_embeddings"]
                               / (rot * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(corr(ys["beta_fast"])), 0)
    high = min(math.ceil(corr(ys["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2).float() - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def softmax_scale(cfg):
    s = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    ys = cfg["rope_scaling"]
    m = yarn_get_mscale(ys["factor"], ys["mscale_all_dim"])
    return s * m * m


def rope(x, positions, cfg):
    """x [..., L, Dr] with channels in pairs -> rotated, in halves."""
    ys = cfg["rope_scaling"]
    freqs = positions.float()[:, None] * yarn_inv_freq(cfg)[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    m = (yarn_get_mscale(ys["factor"], ys["mscale"])
         / yarn_get_mscale(ys["factor"], ys["mscale_all_dim"]))
    cos, sin = emb.cos() * m, emb.sin() * m
    *lead, L, d = x.shape
    x = x.view(*lead, L, d // 2, 2).transpose(-1, -2).reshape(*lead, L, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + half * sin


def mla(h, w, cfg):
    """Decompressed latent attention over h [B, L, d] -> [B, L, d]."""
    B, L, _ = h.shape
    H, Dn, Dr, Dv, R = (cfg["n_heads"], cfg["qk_nope_head_dim"],
                        cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                        cfg["kv_lora_rank"])
    pos = torch.arange(L)
    q = (h @ w["wq"]).view(B, L, H, Dn + Dr).transpose(1, 2)
    q_nope, q_pe = q[..., :Dn], rope(q[..., Dn:], pos, cfg)
    kv_a = h @ w["wkv_a"]
    c_kv = rmsnorm(kv_a[..., :R], w["kv_norm"], cfg["norm_eps"])
    k_pe = rope(kv_a[:, None, :, R:], pos, cfg)               # [B, 1, L, Dr]
    kv = (c_kv @ w["wkv_b"]).view(B, L, H, Dn + Dv).transpose(1, 2)
    k_nope, v = kv[..., :Dn], kv[..., Dn:]
    s = (q_nope @ k_nope.transpose(-1, -2)
         + q_pe @ k_pe.transpose(-1, -2)) * softmax_scale(cfg)
    mask = torch.ones(L, L, dtype=torch.bool).tril()
    o = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1) @ v
    return o.transpose(1, 2).reshape(B, L, H * Dv) @ w["wo"]


def experts(h, w, cfg, groups: Sequence[Tuple[int, int]]):
    B, L, d = h.shape
    E, k = cfg["n_experts"], cfg["top_k"]
    probs = torch.softmax(h @ w["router"], dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)                 # [B, L, k]
    if cfg["renormalize"]:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
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
    eps = cfg["norm_eps"]
    x = w["embed"][tokens.long()]
    for i in range(cfg["n_layers"]):
        lw = {k.split(".", 1)[1]: t for k, t in w.items()
              if k.startswith(f"l{i}.")}
        x = x + mla(rmsnorm(x, lw["norm1"], eps), lw, cfg)
        h = rmsnorm(x, lw["norm2"], eps)
        x = x + (swiglu(h, lw["mlp_gate"], lw["mlp_up"], lw["mlp_down"])
                 if i < cfg["first_k_dense_replace"]
                 else experts(h, lw, cfg, groups))
    x = rmsnorm(x[:, list(positions)], w["final_norm"], eps)
    return x @ w["lm_head"][:cfg["vocab_size"]].T
