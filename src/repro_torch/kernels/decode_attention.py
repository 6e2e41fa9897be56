"""Decode attention over a contiguous (linear or ring) KV cache, on Hopper.

The port of ``src/repro/kernels/decode_attention.py``
(``decode_attention_bhd``).  One new query token per sequence attends the
``S`` slots of its cache; slot ``j`` holds absolute position
``positions[b, j]`` and is valid iff ``0 <= pos < cache_len[b]`` (and
``pos > cache_len[b] - 1 - window`` with a window), so slot order is free
and ring caches work:

* scores are scaled by ``1/sqrt(D)``; GQA groups ``r = H / KV`` query heads
  on each kv head;
* masked scores are ``-1e30``, not ``-inf``, so a row with no valid slot
  returns the uniform mean of V over all ``S`` slots, as the TPU kernel
  and its reference do;
* inputs float32 or bfloat16, float32 accumulation, output in q's dtype.

``decode_attention_bhd`` is the wrapper.  For tensors on the card it
launches the hand-written CUDA kernel in ``csrc/decode_attention.cu`` (one
thread block per (sequence, kv head) with its ``r`` query heads as rows,
a loop over the cache in tiles staged through shared memory; the source
says what bounds it) and raises on what the kernel does not take.  For
tensors on the CPU it computes ``decode_attention_reference``, the plain
PyTorch version and the twin of ``repro.kernels.ref.decode_attention_ref``.
The TPU kernel's ``blk_s``/``interpret`` have no meaning here.

Layouts.  The caches are ``[B, KV, S, D]`` with any strides whose last is
1, so the model passes its ``[B, S, KV, D]`` cache as a transposed view
and nothing is copied; ``cache_len`` and ``positions`` may be broadcast
over the batch (batch stride 0).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS, NEG_INF

MAX_GROUP = 48          # query heads per kv head the kernel takes


def decode_attention_reference(q, k_cache, v_cache, cache_len, positions, *,
                               window: Optional[int] = None):
    """Plain PyTorch, term for term ``repro.kernels.ref.decode_attention_ref``:
    q [B, H, D]; caches [B, KV, S, D]; cache_len [B]; positions [B, S]."""
    B, H, D = q.shape
    KV = k_cache.shape[1]
    qg = q.reshape(B, KV, H // KV, D).float()
    s = torch.einsum("bgrd,bgsd->bgrs", qg, k_cache.float()) / (D ** 0.5)
    clen = cache_len[:, None]
    valid = (positions >= 0) & (positions < clen)
    if window is not None:
        valid &= positions > clen - 1 - window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrs,bgsd->bgrd", a, v_cache.float())
    return o.reshape(B, H, D).to(q.dtype)


def _check(q, k_cache, v_cache, cache_len, positions, window) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"want q [B, H, D] and caches [B, KV, S, D]; got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, H, D = q.shape
    Bk, KV, S, Dk = k_cache.shape
    if Bk != B or Dk != D or S < 1:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if KV < 1 or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"kernel takes H a multiple of KV with H/KV <= "
                         f"{MAX_GROUP}, got H={H} KV={KV}")
    if D not in HEAD_DIMS:
        raise ValueError(f"kernel takes D in {HEAD_DIMS}, got {D}")
    if tuple(cache_len.shape) != (B,) or tuple(positions.shape) != (B, S):
        raise ValueError("want cache_len [B] and positions [B, S]")
    if cache_len.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("cache_len and positions must be int32")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if (q.dtype not in DTYPES or k_cache.dtype != q.dtype
            or v_cache.dtype != q.dtype):
        raise TypeError(f"q and caches must share float32 or bfloat16, got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    vec = 16 // q.element_size()
    for t in (q, k_cache, v_cache, cache_len, positions):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
    for t in (q, k_cache, v_cache):
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError("kernel takes a unit last stride, other strides "
                             "of whole 16-byte rows and 16-byte aligned data")
    if S > 1 and positions.stride(1) != 1:
        raise ValueError("the rows of positions must be contiguous")


def decode_attention_bhd(q, k_cache, v_cache, cache_len, positions, *,
                         window: Optional[int] = None):
    """q: [B, H, D]; caches: [B, KV, S, D] (float32 or bfloat16);
    cache_len: [B] i32; positions: [B, S] i32 (absolute position per slot,
    -1 = never valid).  Returns [B, H, D] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel and
    add one to ``decode_attention_bhd.launches``."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, cache_len,
                                          positions, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k_cache, v_cache, cache_len, positions, window)
    from repro_torch.kernels._build import load_library
    lib = load_library()
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.da_launch(
            DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), cache_len.data_ptr(), positions.data_ptr(),
            out.data_ptr(), B, H, KV, S, D, q.stride(0), q.stride(1),
            *k_cache.stride()[:3], *v_cache.stride()[:3],
            cache_len.stride(0), positions.stride(0),
            -1 if window is None else int(window),
            ctypes.c_float(1.0 / D ** 0.5), stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    decode_attention_bhd.launches += 1
    return out


decode_attention_bhd.launches = 0
