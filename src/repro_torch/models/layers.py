"""Shared neural-net building blocks: the port of ``src/repro/models/layers.py``.

Conventions, as in the reference:
  * matmul-heavy compute stays in the config dtype (bf16 target); norms,
    rotary angles and softmax accumulate in float32, and the elementwise
    rescale of a norm stays in the input dtype, in the reference's order;
  * weights keep the reference's layouts (``[d_in, d_out]`` for a dense
    weight), so that ``repro_torch.models.convert`` copies them as they are.

Modules hold weights (``Norm``, ``MLP``); ``apply_norm``, ``apply_rope``,
``apply_mrope``, ``sinusoid_embed`` and ``apply_mlp`` are plain functions
on tensors.  The
rotary is split into its cos/sin (``rope_cos_sin``, ``mrope_cos_sin``, and
``yarn_cos_sin`` for DeepSeek-V2's YaRN, a port-only addition) and
``rotate``, so that the model computes the angles once per call, not once
per layer.  The init
helpers draw from an explicit ``torch.Generator`` on the target device, and
allocate without drawing on the ``meta`` device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _normal(shape, std: float, dtype, device, generator):
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * std).to(dtype)


def dense_init(d_in: int, d_out: int, dtype, device, generator,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return _normal((d_in, d_out), scale, dtype, device, generator)


def embed_init(vocab: int, d: int, dtype, device, generator) -> torch.Tensor:
    return _normal((vocab, d), 0.02, dtype, device, generator)


def linear(x, w, b=None):
    y = x @ w
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def apply_norm(kind: str, x, scale=None, bias=None, eps: float = 1e-6):
    """``repro.models.layers.apply_norm``: reductions in float32, the
    rescale in the input dtype (same order of operations)."""
    def mean_f32(v):
        return v.float().mean(dim=-1, keepdim=True)

    if kind == "rmsnorm":
        inv = torch.rsqrt(mean_f32(x * x) + eps).to(x.dtype)
        return x * inv * scale.to(x.dtype)
    if kind in ("layernorm", "nonparametric_ln"):
        mu = mean_f32(x)
        xc = x.float() - mu
        y = (xc * torch.rsqrt(mean_f32(xc * xc) + eps)).to(x.dtype)
        if kind == "nonparametric_ln":   # OLMo: LN without learnable affine
            return y
        return y * scale.to(x.dtype) + bias.to(x.dtype)
    raise ValueError(f"unknown norm {kind!r}")


class Norm(nn.Module):
    """rmsnorm (``scale``), layernorm (``scale``, ``bias``) or
    nonparametric_ln (no weights), initialised as the reference does;
    ``eps`` is the reference's 1e-6 unless a configuration states its
    own."""

    def __init__(self, kind: str, d: int, dtype, device, eps: float = 1e-6):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm", "nonparametric_ln"):
            raise ValueError(f"unknown norm {kind!r}")
        self.kind = kind
        self.eps = eps
        if kind != "nonparametric_ln":
            self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        if kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))

    def forward(self, x):
        return apply_norm(self.kind, x, getattr(self, "scale", None),
                          getattr(self, "bias", None), self.eps)


# ---------------------------------------------------------------------------
# rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rotate(x, cos, sin):
    """Rotate the two halves of x [..., S, H, Dh] by angles given as their
    float32 cos and sin, broadcastable to [..., S, 1, Dh // 2]."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """cos and sin of the rotary angles, [..., S, 1, half] for positions
    [..., S]: computed once, they rotate every layer that shares ``theta``."""
    freqs = rope_frequencies(head_dim, theta, positions.device)  # [half]
    angles = positions[..., None].float() * freqs                 # [..., S, half]
    angles = angles[..., None, :]                                 # [..., S, 1, half]
    return torch.cos(angles), torch.sin(angles)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature: ``0.1 mscale ln(factor) + 1`` (1 for
    ``factor <= 1``), as DeepSeek-V2's ``yarn_get_mscale``."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_frequencies(dim: int, theta: float, scaling,
                     device=None) -> torch.Tensor:
    """The rotary frequencies [dim // 2] of ``dim`` rotary channels under
    YaRN (``configs.base.YarnScaling``), as DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``: the dimensions below the
    correction range keep ``rope_frequencies``, those above it take them
    over ``factor``, a linear ramp blends the range between."""
    base = rope_frequencies(dim, theta, device)

    def corr(rotations):     # the dimension at which that many rotations fit
        return dim * math.log(scaling.original_max_position / (
            rotations * 2 * math.pi)) / (2 * math.log(theta))

    lo = max(math.floor(corr(scaling.beta_fast)), 0)
    hi = min(math.ceil(corr(scaling.beta_slow)), dim - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    keep = 1.0 - ramp
    return base / scaling.factor * (1.0 - keep) + base * keep


def yarn_cos_sin(positions, dim: int, theta: float, scaling):
    """``rope_cos_sin`` under YaRN: the frequencies of
    ``yarn_frequencies``, cos and sin scaled by ``mscale(factor, mscale)
    / mscale(factor, mscale_all_dim)``."""
    freqs = yarn_frequencies(dim, theta, scaling, positions.device)
    angles = (positions[..., None].float() * freqs)[..., None, :]
    m = (yarn_mscale(scaling.factor, scaling.mscale)
         / yarn_mscale(scaling.factor, scaling.mscale_all_dim))
    return torch.cos(angles) * m, torch.sin(angles) * m


def mrope_cos_sin(positions_thw, head_dim: int, theta: float,
                  sections: Tuple[int, int, int]):
    """Qwen2-VL multimodal rotary: positions_thw [3, B, S], sections sum to
    head_dim//2; frequency slots are assigned to (t, h, w) position
    streams.  Returns cos and sin, [B, S, 1, half]."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    freqs = rope_frequencies(head_dim, theta, positions_thw.device)  # [half]
    # each stream's positions repeated over its section's slots: views and
    # one copy, no host data (the step is captured in a CUDA graph)
    pos = positions_thw.float()
    pos_per_slot = torch.cat([pos[i:i + 1].expand(n, *pos.shape[1:])
                              for i, n in enumerate(sections)])  # [half, B, S]
    angles = torch.einsum("hbs,h->bsh", pos_per_slot, freqs)      # [B, S, half]
    angles = angles[..., None, :]                                 # [B, S, 1, half]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


def apply_mrope(x, positions_thw, theta: float,
                sections: Tuple[int, int, int]):
    """x: [B, S, H, Dh]; see ``mrope_cos_sin``."""
    return rotate(x, *mrope_cos_sin(positions_thw, x.shape[-1], theta,
                                    sections))


def sinusoid_embed(positions, d: int) -> torch.Tensor:
    """Whisper-style sinusoidal absolute embedding, float32: positions
    [...] (a tensor, on the device at decode) -> [..., d], the sines of
    ``d // 2`` timescales spaced by ``log(10000) / (d // 2 - 1)``, then
    their cosines."""
    half = d // 2
    log_timescale = math.log(10_000.0) / max(half - 1, 1)
    inv = torch.exp(-log_timescale * torch.arange(
        half, dtype=torch.float32, device=positions.device))
    scaled = positions.float()[..., None] * inv
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)


def sinusoid_positions(n_pos: int, d: int, device=None) -> torch.Tensor:
    """The [n_pos, d] float32 table of ``sinusoid_embed``."""
    return sinusoid_embed(torch.arange(n_pos, device=device), d)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def apply_mlp(kind: str, x, w_gate=None, w_up=None, w_down=None, b_up=None,
              b_down=None):
    if kind == "swiglu":
        return linear(F.silu(linear(x, w_gate)) * linear(x, w_up), w_down)
    if kind == "geglu":
        return linear(F.gelu(linear(x, w_gate), approximate="tanh")
                      * linear(x, w_up), w_down)
    if kind == "gelu":
        h = F.gelu(linear(x, w_up, b_up), approximate="tanh")
        return linear(h, w_down, b_down)
    raise ValueError(f"unknown mlp {kind!r}")


class MLP(nn.Module):
    """swiglu / geglu (``w_gate``, ``w_up``, ``w_down``) or gelu (``w_up``,
    ``b_up``, ``w_down``, ``b_down``), weights ``[d_in, d_out]``."""

    def __init__(self, kind: str, d_model: int, d_ff: int, dtype, device,
                 generator):
        super().__init__()
        self.kind = kind
        if kind in ("swiglu", "geglu"):
            self.w_gate = nn.Parameter(dense_init(d_model, d_ff, dtype,
                                                  device, generator))
            self.w_up = nn.Parameter(dense_init(d_model, d_ff, dtype,
                                                device, generator))
            self.w_down = nn.Parameter(dense_init(d_ff, d_model, dtype,
                                                  device, generator))
        elif kind == "gelu":
            self.w_up = nn.Parameter(dense_init(d_model, d_ff, dtype,
                                                device, generator))
            self.b_up = nn.Parameter(torch.zeros(d_ff, dtype=dtype,
                                                 device=device))
            self.w_down = nn.Parameter(dense_init(d_ff, d_model, dtype,
                                                  device, generator))
            self.b_down = nn.Parameter(torch.zeros(d_model, dtype=dtype,
                                                   device=device))
        else:
            raise ValueError(f"unknown mlp {kind!r}")

    def forward(self, x):
        return apply_mlp(self.kind, x, **dict(self.named_parameters()))
