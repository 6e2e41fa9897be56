"""Flash attention for prefill, on Hopper.

The port of ``src/repro/kernels/flash_attention.py``
(``flash_attention_bhsd``).  Every query position attends the key
positions its masks allow, with an online softmax over kv tiles:

* scores are scaled by ``1/sqrt(D)``;
* GQA: query head ``bh`` reads kv head ``bh // r`` with ``r = BH / BKV``;
* ``causal`` keeps key positions ``<=`` the query position, ``window``
  keeps key positions ``> qpos - window``; masked scores are ``-1e30``;
* inputs float32 or bfloat16, float32 accumulation, output in q's dtype.

``flash_attention_bhsd`` is the wrapper.  For tensors on the card it
launches one of two hand-written CUDA kernels, chosen by dtype and head
dim (``route``), and raises on what neither takes:

* ``"wgmma"``, bfloat16 with ``D`` in ``WGMMA_HEAD_DIMS`` (64, 128, 256:
  every attention model of the zoo): ``csrc/flash_attention_wgmma.cu``,
  tensor cores (``wgmma``) fed by TMA through a two-stage ring, 64 query
  rows per warpgroup;
* ``"simt"``, float32 at every head dim and bfloat16 at ``D`` 16 and 32
  (test shapes only): ``csrc/flash_attention.cu``, fp32 FMAs on CUDA
  cores, which keeps float32 within 2e-5 of the plain version.

Both skip fully masked kv tiles; the sources say what bounds them.  The
choice is fixed, not a fallback: a failed launch raises.  Each launch adds
one to ``flash_attention_bhsd.launches`` and to its route's entry in
``flash_attention_bhsd.launches_by_route``.  For tensors on the CPU the
wrapper computes ``flash_attention_reference``, the plain PyTorch version
and the twin of ``repro.kernels.ref.flash_attention_ref``.  The TPU
kernel's ``blk_q``/``blk_k``/``interpret`` have no meaning here.

Layouts.  Besides the TPU kernel's ``[BH, S, D]``, the wrapper takes
``[B, H, S, D]`` tensors with any strides whose last one is 1, so the
model passes ``[B, S, H, D]`` activations as transposed views and nothing
is copied; the result is then a ``[B, H, S, D]`` view of a tensor laid
out ``[B, S, H, D]``.  ``[BH, S, D]`` is the case ``B = 1``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WGMMA_HEAD_DIMS = (64, 128, 256)    # bf16 head dims of the tensor-core kernel


def route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel takes a call on the card: ``"wgmma"`` for bfloat16 at
    the head dims of ``WGMMA_HEAD_DIMS``, else ``"simt"``."""
    return ("wgmma" if dtype == torch.bfloat16
            and head_dim in WGMMA_HEAD_DIMS else "simt")


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              window: Optional[int] = None):
    """Plain PyTorch, term for term ``repro.kernels.ref.flash_attention_ref``:
    q [BH, S, D] (or [B, H, S, D]); k, v [BKV, S, D] (or [B, KV, S, D])."""
    shape = q.shape
    if q.dim() == 4:
        q, k, v = (t.reshape(-1, *t.shape[2:]) for t in (q, k, v))
    BH, S, D = q.shape
    r = BH // k.shape[0]
    kx = torch.repeat_interleave(k, r, dim=0).float()
    vx = torch.repeat_interleave(v, r, dim=0).float()
    s = torch.einsum("hqd,hkd->hqk", q.float(), kx) / (D ** 0.5)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", a, vx).to(q.dtype).reshape(shape)


def _as4(t: torch.Tensor) -> torch.Tensor:
    return t.unsqueeze(0) if t.dim() == 3 else t


def _check(q, k, v, window) -> None:
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.shape != k.shape:
        raise ValueError(f"want q [BH, S, D] or [B, H, S, D] and k, v of the "
                         f"same rank and shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = _as4(q).shape
    Bk, KV, Sk, Dk = _as4(k).shape
    if Bk != B or Sk != S or Dk != D or S < 1:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"kernel takes D in {HEAD_DIMS}, got {D}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    vec = 16 // q.element_size()           # elements per 16-byte load
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError("kernel takes a unit last stride, other strides "
                             "of whole 16-byte rows and 16-byte aligned data")


def flash_attention_bhsd(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None):
    """q: [BH, S, D] or [B, H, S, D]; k, v: [BKV, S, D] or [B, KV, S, D];
    float32 or bfloat16.  Returns q's shape and dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    ``route(q.dtype, D)`` and add one to ``flash_attention_bhsd.launches``
    and to that route's count in ``launches_by_route``."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, window)
    from repro_torch.kernels._build import load_library
    lib = load_library()
    q4, k4, v4 = _as4(q), _as4(k), _as4(v)
    B, H, S, D = q4.shape
    KV = k4.shape[1]
    if q.dim() == 3:
        out4 = torch.empty_like(q, memory_format=torch.contiguous_format
                                ).unsqueeze(0)
    else:   # laid out [B, S, H, D], returned as a [B, H, S, D] view
        out4 = torch.empty((B, S, H, D), dtype=q.dtype,
                           device=q.device).transpose(1, 2)
    which = route(q.dtype, D)
    args = (q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out4.data_ptr(),
            B, H, KV, S, D, *q4.stride()[:3], *k4.stride()[:3],
            *v4.stride()[:3], *out4.stride()[:3], int(causal),
            -1 if window is None else int(window))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which == "wgmma":        # exp2 scores: log2(e) folded in
            err = lib.fa_wgmma_launch(
                *args, ctypes.c_float(math.log2(math.e) / D ** 0.5), stream)
        else:
            err = lib.fa_launch(DTYPES[q.dtype], *args,
                                ctypes.c_float(1.0 / D ** 0.5), stream)
    if err:
        raise RuntimeError(f"flash_attention {which} launch failed: error "
                           f"{err}")
    flash_attention_bhsd.launches += 1
    flash_attention_bhsd.launches_by_route[which] += 1
    return out4 if q.dim() == 4 else out4[0]


flash_attention_bhsd.launches = 0
flash_attention_bhsd.launches_by_route = {"wgmma": 0, "simt": 0}
