"""Plain reference of granite-4.0-h (``granitemoehybrid``), as
``portbench/configs/granite-4.0-h-small-pp2.json`` configures it.

Embeddings ``E[token] * embedding_multiplier``.  Each layer ``i`` runs the
mixer ``layer_types[i]`` names, then the experts, each branch added back as
``x + residual_multiplier * branch``:

- ``h = RMSNorm(x)`` (the mean of squares in float32, eps from the
  configuration), then the mixer on ``h``:
  - ``mamba``, Mamba-2 as published: ``[z, xBC, dt] = h W_in``; ``xBC``
    through the causal depthwise conv of 4 taps with its bias, then SiLU,
    and cut into ``x`` (heads of ``ssm_head_dim``), ``B`` and ``C``
    (``n_groups`` groups of ``d_state``, head ``h`` reading group
    ``h // (heads / groups)``); ``dt = softplus(dt + dt_bias)``,
    ``A = -exp(A_log)``; per head ``s_t = exp(dt_t A) s_{t-1} +
    dt_t x_t B_t^T`` and ``y_t = s_t C_t + D x_t``; then
    ``RMSNorm(y * silu(z))`` over each group's channels, times its scale,
    and ``W_out``.  The recurrence runs as the chunked SSD, the chunks in
    order with the state carried between them (``_ssd``): the same
    function, summed in another order.
  - ``attention``: GQA without positions (NoPE), causal, scores
    ``q k^T * attention_multiplier``, softmax, ``v``, then ``W_o``.
- ``h = RMSNorm(x)``; the experts: the router's float32 logits, the top
  ``k`` of them, a softmax over those, each chosen expert a SwiGLU
  ``silu(h W_gate) * (h W_up) W_down`` weighted by its gate; plus the
  shared expert, the same SwiGLU at its own width with no gate.

Then a final RMSNorm and logits against the tied embedding, divided by
``logits_scaling``.  Float32 throughout (the caller turns TF32 off);
``precision`` rounds the inputs of every dense product and of attention's
two products (``numerics.matmul``), while the router, the conv and the
SSD stay float32.

The one departure from the published model is the program's: capacity.
Each call of the model routes its own tokens, and an expert takes at most
``C = max(4, ceil4(floor(N * k * factor / E) + 1))`` of the ``N`` tokens
of the call; assignments beyond C are dropped, in the order of the
flattened (token, choice) list.  ``groups`` tells the reference which
positions were routed together (a prefill over all prompts, then one call
a decode step).

The weights are drawn in bfloat16 (the routers and Mamba-2's ``A_log``,
``dt_bias`` and ``D`` in float32) on the device from one seeded generator,
tensor by tensor (``iter_weights``), and each layer's are raised to
float32 only while that layer runs: the model whole in float32 would not
fit on one card beside its activations.

The four products that write a residual branch (Mamba-2's ``W_out``,
attention's ``W_o``, the experts' and the shared expert's ``W_down``) are
drawn at ``OUT_GAIN / sqrt(fan-in)``, the others at ``1 / sqrt(fan-in)``.
At gain 1 the embedding's x12 and the branches' x0.22 leave the residual
stream mostly the input token's tied embedding, whose product with itself
decides the argmax: every position's best logit was its input token (2 x
1,024 positions on the card), for the program and a rounded control
alike, and the check could tell nothing apart.  At 4, 16.5% of positions
copied their input, at 8, 0.24%; a trained model's residual stream grows
through its layers in the same way.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.numerics import matmul

# the scale of the residual-writing products over 1/sqrt(fan-in) (above)
OUT_GAIN = 8.0


def shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], tuple]]:
    """(name, shape, how it is drawn) of every weight, in drawing order:
    ``("normal", std)``, ``("router", std)``, ``("ones",)``,
    ``("ones32",)``, ``("uniform", bound)``, ``("A_log",)``,
    ``("dt_bias",)``."""
    d, H, KV, Dh = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                    cfg["head_dim"])
    E, f, fs = cfg["n_experts"], cfg["d_ff_expert"], cfg["shared_d_ff"]
    nh, hd, n, G = (cfg["ssm_heads"], cfg["ssm_head_dim"], cfg["d_state"],
                    cfg["n_groups"])
    di = nh * hd
    conv = di + 2 * G * n
    K = cfg["d_conv"]
    g = OUT_GAIN
    out = [("embed", (cfg["padded_vocab"], d), ("normal", 0.02)),
           ("final_norm", (d,), ("ones",))]
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"l{i}."
        out.append((p + "norm1", (d,), ("ones",)))
        if kind == "mamba":
            out += [(p + "w_in", (d, di + conv + nh), ("normal", d ** -0.5)),
                    (p + "conv_w", (K, conv), ("uniform", K ** -0.5)),
                    (p + "conv_b", (conv,), ("uniform", K ** -0.5)),
                    (p + "dt_bias", (nh,), ("dt_bias",)),
                    (p + "A_log", (nh,), ("A_log",)),
                    (p + "D", (nh,), ("ones32",)),
                    (p + "ssm_norm", (di,), ("ones",)),
                    (p + "w_out", (di, d), ("normal", g * di ** -0.5))]
        else:
            out += [(p + "wq", (d, H * Dh), ("normal", d ** -0.5)),
                    (p + "wk", (d, KV * Dh), ("normal", d ** -0.5)),
                    (p + "wv", (d, KV * Dh), ("normal", d ** -0.5)),
                    (p + "wo", (H * Dh, d), ("normal", g * (H * Dh) ** -0.5))]
        out += [(p + "norm2", (d,), ("ones",)),
                (p + "router", (d, E), ("router", d ** -0.5)),
                (p + "w_gate", (E, d, f), ("normal", d ** -0.5)),
                (p + "w_up", (E, d, f), ("normal", d ** -0.5)),
                (p + "w_down", (E, f, d), ("normal", g * f ** -0.5)),
                (p + "shared_gate", (d, fs), ("normal", d ** -0.5)),
                (p + "shared_up", (d, fs), ("normal", d ** -0.5)),
                (p + "shared_down", (fs, d), ("normal", g * fs ** -0.5))]
    return out


def iter_weights(cfg: Dict, seed: int,
                 device) -> Iterator[Tuple[str, torch.Tensor]]:
    """Every weight in ``shapes``' order, each drawn on ``device`` from one
    generator seeded with ``seed``: normal weights in bfloat16 (the
    routers in float32); the conv's weights and bias uniform in
    ``[-1/sqrt(K), 1/sqrt(K)]``, as a conv layer is initialised; ``A``
    uniform in [1, 16] and ``dt`` log-uniform in [0.001, 0.1] (through the
    inverse softplus), as Mamba-2 initialises them; unit norms and ``D``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    bf16, f32 = torch.bfloat16, torch.float32

    def rand(shape):
        return torch.rand(shape, generator=g, device=device, dtype=f32)

    for name, shape, how in shapes(cfg):
        kind = how[0]
        if kind in ("normal", "router"):
            t = torch.randn(shape, generator=g, device=device,
                            dtype=bf16 if kind == "normal" else f32)
            t.mul_(how[1])
        elif kind == "ones":
            t = torch.ones(shape, dtype=bf16, device=device)
        elif kind == "ones32":
            t = torch.ones(shape, dtype=f32, device=device)
        elif kind == "uniform":
            t = ((2 * rand(shape) - 1) * how[1]).to(bf16)
        elif kind == "A_log":
            t = torch.log(1.0 + 15.0 * rand(shape))
        else:
            lo, hi = math.log(1e-3), math.log(1e-1)
            dt = torch.exp(lo + (hi - lo) * rand(shape)).clamp_min(1e-4)
            t = dt + torch.log(-torch.expm1(-dt))
        yield name, t


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return dict(iter_weights(cfg, seed, device))


def capacity(n_tokens: int, top_k: int, factor: float, n_experts: int) -> int:
    c = int(n_tokens * top_k * factor / n_experts) + 1
    return max(4, -(-c // 4) * 4)


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * \
        scale.float()


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


def _ffn(h, w, cfg, groups, precision):
    """The experts plus the shared expert on h [B, L, d] float32."""
    B, L, d = h.shape
    logits = h @ w["router"]
    top, idx = torch.topk(logits, cfg["top_k"], dim=-1)
    gates = torch.softmax(top, dim=-1) * _kept(idx, groups, B, cfg)
    flat = h.reshape(B * L, d)
    y = torch.zeros_like(flat)
    idx, gates = idx.reshape(B * L, -1), gates.reshape(B * L, -1)
    for e in range(cfg["n_experts"]):
        tok, choice = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = flat[tok]
        u = F.silu(matmul(x, w["w_gate"][e], precision)) * \
            matmul(x, w["w_up"][e], precision)
        y.index_add_(0, tok, matmul(u, w["w_down"][e], precision)
                     * gates[tok, choice, None])
    shared = matmul(F.silu(matmul(flat, w["shared_gate"], precision))
                    * matmul(flat, w["shared_up"], precision),
                    w["shared_down"], precision)
    return (y + shared).view(B, L, d)


def _attention(h, w, cfg, precision, block: int = 256):
    """Causal GQA without positions over query blocks -> [B, L, d]."""
    B, L, _ = h.shape
    H, KV, Dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    r = H // KV
    q = matmul(h, w["wq"], precision).view(B, L, KV, r, Dh)
    k = matmul(h, w["wk"], precision).view(B, L, KV, Dh)
    v = matmul(h, w["wv"], precision).view(B, L, KV, Dh)
    kt = k.permute(0, 2, 3, 1)[:, :, None]                    # [B,KV,1,Dh,L]
    vt = v.permute(0, 2, 1, 3)[:, :, None]                    # [B,KV,1,L,Dh]
    out = torch.empty(B, L, H * Dh, device=h.device)
    pos = torch.arange(L, device=h.device)
    for lo in range(0, L, block):
        hi = min(L, lo + block)
        qb = q[:, lo:hi].permute(0, 2, 3, 1, 4)               # [B,KV,r,q,Dh]
        s = matmul(qb, kt[..., :hi], precision) * cfg["attention_multiplier"]
        s = s.masked_fill(pos[None, :hi] > pos[lo:hi, None], float("-inf"))
        o = matmul(torch.softmax(s, dim=-1), vt[..., :hi, :], precision)
        out[:, lo:hi] = o.permute(0, 3, 1, 2, 4).reshape(B, hi - lo, H * Dh)
    return matmul(out, w["wo"], precision)


def _ssd(x, dt, A, Bh, Ch, T: int):
    """The recurrence in chunks of T positions, the state carried from
    chunk to chunk.  x [B, L, nh, hd], dt [B, L, nh], A [nh], Bh and Ch
    [B, L, nh, n] -> y [B, L, nh, hd] without the D term."""
    B, L, nh, hd = x.shape
    s = torch.zeros(B, nh, hd, Bh.shape[-1], device=x.device)
    y = torch.empty_like(x)
    for lo in range(0, L, T):
        hi = min(L, lo + T)
        a = (dt[:, lo:hi] * A).cumsum(1).transpose(1, 2)      # [B, nh, t]
        xd = (x[:, lo:hi] * dt[:, lo:hi, :, None]).transpose(1, 2)
        b = Bh[:, lo:hi].transpose(1, 2)                      # [B, nh, t, n]
        c = Ch[:, lo:hi].transpose(1, 2)
        t = hi - lo
        keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        decay = (a[..., :, None] - a[..., None, :]).masked_fill(
            ~keep, float("-inf")).exp()                       # [B,nh,t,t]
        yc = ((c @ b.transpose(-1, -2)) * decay) @ xd         # [B,nh,t,hd]
        yc = yc + (c @ s.transpose(-1, -2)) * a.exp()[..., None]
        y[:, lo:hi] = yc.transpose(1, 2)
        last = a[..., -1:]
        s = s * last.exp()[..., None] + \
            (xd * (last - a).exp()[..., None]).transpose(-1, -2) @ b
    return y


def _mamba(h, w, cfg, precision):
    """Mamba-2 as published on h [B, L, d] float32 -> [B, L, d]."""
    B, L, _ = h.shape
    nh, hd, n, G = (cfg["ssm_heads"], cfg["ssm_head_dim"], cfg["d_state"],
                    cfg["n_groups"])
    di, K = nh * hd, cfg["d_conv"]
    z, xbc, dt = matmul(h, w["w_in"], precision).split(
        [di, di + 2 * G * n, nh], dim=-1)
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(xp[:, j:j + L] * w["conv_w"][j] for j in range(K))
    xbc = F.silu(conv + w["conv_b"])
    x, b, c = xbc.split([di, G * n, G * n], dim=-1)
    x = x.reshape(B, L, nh, hd)
    per = nh // G
    b = b.reshape(B, L, G, n).repeat_interleave(per, dim=2)
    c = c.reshape(B, L, G, n).repeat_interleave(per, dim=2)
    dt = F.softplus(dt + w["dt_bias"])
    y = _ssd(x, dt, -torch.exp(w["A_log"]), b, c, cfg["chunk"])
    y = (y + w["D"][:, None] * x).reshape(B, L, G, di // G)
    g = (y * F.silu(z).reshape(B, L, G, di // G))
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + cfg["norm_eps"])
    return matmul(g.reshape(B, L, di) * w["ssm_norm"], w["w_out"], precision)


@torch.no_grad()
def logits_at(w: Dict[str, torch.Tensor], cfg: Dict, tokens: torch.Tensor,
              groups: Sequence[Tuple[int, int]], positions: Sequence[int],
              precision=None) -> torch.Tensor:
    """Logits [B, len(positions), vocab] float32 at ``positions`` of the
    streams ``tokens`` [B, L] (each position's logits predict the next
    token), the model run over the whole streams layer by layer, the
    experts' capacity taken call by call (``groups``)."""
    precision = precision or "float32"
    eps, m = cfg["norm_eps"], cfg["residual_multiplier"]
    x = w["embed"][tokens.long()].float() * cfg["embedding_multiplier"]
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"l{i}."
        wl = {k[len(p):]: t.float() for k, t in w.items()
              if k.startswith(p)}
        h = _rms(x, wl["norm1"], eps)
        y = (_mamba(h, wl, cfg, precision) if kind == "mamba"
             else _attention(h, wl, cfg, precision))
        x = x + m * y
        x = x + m * _ffn(_rms(x, wl["norm2"], eps), wl, cfg, groups,
                         precision)
        del wl, h, y
    x = _rms(x[:, list(positions)], w["final_norm"], eps)
    return matmul(x, w["embed"][:cfg["vocab_size"]].float().T,
                  precision) / cfg["logits_scaling"]
