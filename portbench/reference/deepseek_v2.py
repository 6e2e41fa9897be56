"""Plain reference of DeepSeek-V2 (``deepseek_v2``), as
``portbench/configs/deepseek-v2-lite.json`` configures it.

Embeddings ``E[token]``.  Each layer ``i``: ``x = x + MLA(RMSNorm(x))``,
then ``x = x + FFN_i(RMSNorm(x))`` (eps from the configuration):

- MLA, decompressed, no compression of q: ``q = h W_q``, each head's
  ``[q_nope, q_pe]``; ``[c_kv, k_pe] = h W_kv_a`` and ``c_kv =
  RMSNorm(c_kv)``; ``[k_nope, v] = c_kv W_kv_b``, each head's; ``q_pe``
  and the one ``k_pe`` all heads share rotated as published: channel
  pairs (2i, 2i + 1) regrouped as halves, then ``x cos + rotate_half(x)
  sin`` at YaRN's frequencies (cos and sin times ``mscale(factor,
  mscale) / mscale(factor, mscale_all_dim)``); causal softmax of
  ``(q_nope . k_nope + q_pe . k_pe) scale``, ``scale = (Dn + Dr)^-1/2
  mscale(factor, mscale_all_dim)^2``; ``o v``, then ``W_o``.
- FFN: a SwiGLU ``silu(h W_gate) * (h W_up) W_down`` of ``intermediate
  size`` in the first ``first_k_dense_replace`` layers; in the others the
  router's float32 logits, their softmax over all experts, the top ``k``
  probabilities as the gates (over their sum only where ``norm_topk_prob``
  is set, which DeepSeek-V2-Lite's is not; ``routed_scaling_factor`` 1),
  each chosen expert a SwiGLU weighted by
  its gate, plus the shared experts, one SwiGLU of ``n_shared_experts x
  moe_intermediate_size`` with no gate.

Then a final RMSNorm and logits against the untied head.  Float32
throughout (the caller turns TF32 off); ``precision`` rounds the inputs of
every dense product and of attention's two products
(``numerics.matmul``), while the router and the norms stay float32.
Attention runs over blocks of queries, so that it fits beside a 32,896-
token stream.

The one departure from the published model is the program's: capacity.
Each call of the model routes its own tokens, and an expert takes at most
``C = max(4, ceil4(floor(N * k * factor / E) + 1))`` of the ``N`` tokens
of the call; assignments beyond C are dropped, in the order of the
flattened (token, choice) list.  ``groups`` tells the reference which
positions were routed together (a prefill over all prompts, then one call
a decode step).

The weights are drawn in bfloat16 (the routers in float32) on the device
from one seeded generator, tensor by tensor (``iter_weights``), every
dense product at ``1 / sqrt(fan-in)``, the embedding and the head at
0.02, the norms at one, and each layer's are raised to float32 only while
that layer runs.  The rotary columns of ``W_q`` and ``W_kv_a`` are drawn
in the published interleaved order; the program reorders them once when
it lays them in.

Each head's rotary query columns are not drawn on their own: they are the
rotary key columns of ``W_kv_a`` (the one ``k_pe`` every head shares)
times ``ROPE_TIE``, so a position's score against its own slot holds
``ROPE_TIE |k_pe|^2`` (the rotations cancel), about ``ROPE_TIE x Dr`` before
the scale, while its scores against other slots stay centred on zero.
Drawn independently, a query's scores have a spread of about 1.3 and its
softmax covers the whole prompt: at 32,768 positions the last 128 slots,
its own included, held 0.4% of a head's weight (one layer at the
published widths, on the CPU), so a decode step that left its latent
slot unwritten served tokens whose mean gap (0.011 on an H100) lay within
twice the sound program's.  At ``ROPE_TIE`` 1.5 a position's own slot
holds about a third of the weight at 32,768 (0.35 on average, 0.004 to
0.98 over heads and queries), as the heads of a trained model that look
at the current token do, and the rest is spread over the prompt as
before; that fault then reads 3.95, against the sound program's
0.023-0.028 (``PERF.md`` section 2).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.numerics import matmul

# each head's rotary query columns over the shared rotary key columns
ROPE_TIE = 1.5


def shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], tuple]]:
    """(name, shape, how it is drawn) of every weight, in drawing order:
    ``("normal", std)``, ``("router", std)`` or ``("ones",)``."""
    d, H, V = cfg["d_model"], cfg["n_heads"], cfg["padded_vocab"]
    Dn, Dr, Dv, R = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"], cfg["kv_lora_rank"])
    E, f, fs, fd = (cfg["n_experts"], cfg["d_ff_expert"], cfg["shared_d_ff"],
                    cfg["d_ff"])
    out = [("embed", (V, d), ("normal", 0.02))]
    for i in range(cfg["n_layers"]):
        p = f"l{i}."
        out += [(p + "norm1", (d,), ("ones",)),
                (p + "wkv_a", (d, R + Dr), ("normal", d ** -0.5)),
                (p + "wq", (d, H * (Dn + Dr)), ("normal", d ** -0.5)),
                (p + "kv_norm", (R,), ("ones",)),
                (p + "wkv_b", (R, H * (Dn + Dv)), ("normal", R ** -0.5)),
                (p + "wo", (H * Dv, d), ("normal", (H * Dv) ** -0.5)),
                (p + "norm2", (d,), ("ones",))]
        if i < cfg["first_k_dense_replace"]:
            out += [(p + "mlp_gate", (d, fd), ("normal", d ** -0.5)),
                    (p + "mlp_up", (d, fd), ("normal", d ** -0.5)),
                    (p + "mlp_down", (fd, d), ("normal", fd ** -0.5))]
        else:
            out += [(p + "router", (d, E), ("router", d ** -0.5)),
                    (p + "w_gate", (E, d, f), ("normal", d ** -0.5)),
                    (p + "w_up", (E, d, f), ("normal", d ** -0.5)),
                    (p + "w_down", (E, f, d), ("normal", f ** -0.5)),
                    (p + "shared_gate", (d, fs), ("normal", d ** -0.5)),
                    (p + "shared_up", (d, fs), ("normal", d ** -0.5)),
                    (p + "shared_down", (fs, d), ("normal", fs ** -0.5))]
    out += [("final_norm", (d,), ("ones",)),
            ("lm_head", (V, d), ("normal", 0.02))]
    return out


def iter_weights(cfg: Dict, seed: int,
                 device) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every weight in ``shapes``' order, each drawn on ``device`` from one
    generator seeded with ``seed``: normal weights in bfloat16, the
    routers in float32, unit norms; ``W_q``'s rotary columns then set to
    ``ROPE_TIE`` times the layer's rotary key columns."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    H, Dn, R = cfg["n_heads"], cfg["qk_nope_head_dim"], cfg["kv_lora_rank"]
    for name, shape, how in shapes(cfg):
        if how[0] == "ones":
            t = torch.ones(shape, dtype=torch.bfloat16, device=device)
        else:
            t = torch.randn(shape, generator=g, device=device,
                            dtype=torch.bfloat16 if how[0] == "normal"
                            else torch.float32)
            t.mul_(how[1])
        if name.endswith(".wkv_a"):
            k_rope = t[:, R:]
        elif name.endswith(".wq"):
            t.view(shape[0], H, -1)[..., Dn:] = ROPE_TIE * k_rope[:, None]
        yield name, t


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return dict(iter_weights(cfg, seed, device))


def capacity(n_tokens: int, top_k: int, factor: float, n_experts: int) -> int:
    c = int(n_tokens * top_k * factor / n_experts) + 1
    return max(4, -(-c // 4) * 4)


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * \
        scale.float()


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def _inv_freq(cfg: Dict, device) -> torch.Tensor:
    """YaRN's rotary frequencies, as ``DeepseekV2YarnRotaryEmbedding``."""
    dim, base, ys = (cfg["qk_rope_head_dim"], cfg["rope_theta"],
                     cfg["rope_scaling"])
    exps = torch.arange(0, dim, 2, device=device).float() / dim
    extra, inter = 1.0 / base ** exps, 1.0 / (ys["factor"] * base ** exps)

    def corr(rot):
        return dim * math.log(ys["original_max_position_embeddings"]
                              / (rot * 2 * math.pi)) / (2 * math.log(base))

    lo = max(math.floor(corr(ys["beta_fast"])), 0)
    hi = min(math.ceil(corr(ys["beta_slow"])), dim - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(dim // 2, device=device).float() - lo)
            / (hi - lo)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


def scale(cfg: Dict) -> float:
    """The scores' softmax scale."""
    ys = cfg["rope_scaling"]
    return ((cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
            * _mscale(ys["factor"], ys["mscale_all_dim"]) ** 2)


def _rope(x, cos, sin):
    """x [..., L, Dr], channels in pairs -> rotated, channels in halves."""
    *lead, L, d = x.shape
    x = x.view(*lead, L, d // 2, 2).transpose(-1, -2).reshape(*lead, L, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + half * sin


def _mla(h, w, cfg, precision, block: int = 256):
    """Decompressed latent attention over h [B, L, d] float32 -> [B, L, d],
    causal, over blocks of queries."""
    B, L, _ = h.shape
    H, Dn, Dr, Dv, R = (cfg["n_heads"], cfg["qk_nope_head_dim"],
                        cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                        cfg["kv_lora_rank"])
    ys = cfg["rope_scaling"]
    pos = torch.arange(L, device=h.device)
    freqs = pos.float()[:, None] * _inv_freq(cfg, h.device)[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    m = _mscale(ys["factor"], ys["mscale"]) / _mscale(ys["factor"],
                                                      ys["mscale_all_dim"])
    cos, sin = emb.cos() * m, emb.sin() * m
    q = matmul(h, w["wq"], precision).view(B, L, H, Dn + Dr).transpose(1, 2)
    q = torch.cat([q[..., :Dn], _rope(q[..., Dn:], cos, sin)], dim=-1)
    kv_a = matmul(h, w["wkv_a"], precision)
    c_kv = _rms(kv_a[..., :R], w["kv_norm"], cfg["norm_eps"])
    k_pe = _rope(kv_a[:, None, :, R:], cos, sin)              # [B, 1, L, Dr]
    del kv_a
    kv = matmul(c_kv, w["wkv_b"], precision).view(
        B, L, H, Dn + Dv).transpose(1, 2)
    k = torch.cat([kv[..., :Dn], k_pe.expand(B, H, L, Dr)], dim=-1)
    v = kv[..., Dn:]
    del kv, c_kv
    kt = k.transpose(-1, -2)                                  # [B, H, Dq, L]
    out = torch.empty(B, L, H * Dv, device=h.device)
    s_scale = scale(cfg)
    for lo in range(0, L, block):
        hi = min(L, lo + block)
        s = matmul(q[:, :, lo:hi], kt[..., :hi], precision) * s_scale
        s = s.masked_fill(pos[None, :hi] > pos[lo:hi, None], float("-inf"))
        o = matmul(torch.softmax(s, dim=-1), v[:, :, :hi], precision)
        out[:, lo:hi] = o.transpose(1, 2).reshape(B, hi - lo, H * Dv)
    return matmul(out, w["wo"], precision)


def _kept(idx, groups: Sequence[Tuple[int, int]], B: int, cfg: Dict):
    """idx [B, L, k] -> bool [B, L, k]: which assignments their expert
    takes, call by call (the positions a..b-1 of every row flattened row
    by row)."""
    E, k = cfg["n_experts"], cfg["top_k"]
    keep = torch.zeros_like(idx, dtype=torch.bool)
    for a, b in groups:
        sub = idx[:, a:b].reshape(-1)
        C = capacity(B * (b - a), k, cfg["capacity_factor"], E)
        onehot = F.one_hot(sub, E)
        rank = (onehot.cumsum(0) * onehot).sum(-1) - 1
        keep[:, a:b] = (rank < C).view(B, b - a, k)
    return keep


def _swiglu(x, g, u, dn, precision):
    return matmul(F.silu(matmul(x, g, precision)) * matmul(x, u, precision),
                  dn, precision)


def _experts(h, w, cfg, groups, precision):
    """The routed experts plus the shared experts on h [B, L, d] float32."""
    B, L, d = h.shape
    probs = torch.softmax(h @ w["router"], dim=-1)
    gates, idx = torch.topk(probs, cfg["top_k"], dim=-1)
    if cfg["renormalize"]:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-20)
    gates = gates * _kept(idx, groups, B, cfg)
    flat = h.reshape(B * L, d)
    y = torch.zeros_like(flat)
    idx, gates = idx.reshape(B * L, -1), gates.reshape(B * L, -1)
    for e in range(cfg["n_experts"]):
        tok, choice = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y.index_add_(0, tok, _swiglu(flat[tok], w["w_gate"][e], w["w_up"][e],
                                     w["w_down"][e], precision)
                     * gates[tok, choice, None])
    shared = _swiglu(flat, w["shared_gate"], w["shared_up"],
                     w["shared_down"], precision)
    return (y + shared).view(B, L, d)


@torch.no_grad()
def logits_at(w: Dict[str, torch.Tensor], cfg: Dict, tokens: torch.Tensor,
              groups: Sequence[Tuple[int, int]], positions: Sequence[int],
              precision=None) -> torch.Tensor:
    """Logits [B, len(positions), vocab] float32 at ``positions`` of the
    streams ``tokens`` [B, L] (each position's logits predict the next
    token), the model run over the whole streams layer by layer, the
    experts' capacity taken call by call (``groups``)."""
    precision = precision or "float32"
    eps = cfg["norm_eps"]
    x = w["embed"][tokens.long()].float()
    for i in range(cfg["n_layers"]):
        p = f"l{i}."
        wl = {k[len(p):]: t.float() for k, t in w.items()
              if k.startswith(p)}
        x = x + _mla(_rms(x, wl["norm1"], eps), wl, cfg, precision)
        h = _rms(x, wl["norm2"], eps)
        x = x + (_swiglu(h, wl["mlp_gate"], wl["mlp_up"], wl["mlp_down"],
                         precision)
                 if i < cfg["first_k_dense_replace"]
                 else _experts(h, wl, cfg, groups, precision))
        del wl, h
    x = _rms(x[:, list(positions)], w["final_norm"], eps)
    return matmul(x, w["lm_head"][:cfg["vocab_size"]].float().T, precision)
