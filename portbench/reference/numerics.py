"""Matrix products at a stated precision, for the plain references and
their controls.

``float32``: float32 products with TF32 off (the caller turns it off on a
card).  ``tf32`` and ``fp8``: each input of a product is first rounded to
that format, then multiplied in float32, which is what a tensor core does
with such inputs (products exact, float32 sums).  TF32 keeps 10 bits of
mantissa (rounded to nearest); fp8 is e4m3 with a scale per row of the
left input and per column of the right one (their largest magnitude maps
to 448, e4m3's largest finite value).
"""
from __future__ import annotations

import torch

PRECISIONS = ("float32", "tf32", "fp8")
E4M3_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, nearest, ties away."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x in e4m3 with one scale per slice along ``dim`` (its largest
    magnitude at 448), back in float32."""
    x = x.float()
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a [..., K] @ b [..., K, N] in float32 after rounding the inputs to
    ``precision``."""
    if precision == "float32":
        return a.float() @ b.float()
    if precision == "tf32":
        return round_tf32(a) @ round_tf32(b)
    if precision == "fp8":
        return round_fp8(a, -1) @ round_fp8(b, -2)
    raise ValueError(f"unknown precision {precision!r}")
