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
launches the hand-written CUDA kernel in ``csrc/decode_attention.cu`` and
raises on what the kernel does not take.  The kernel splits the cache over
``n_splits`` blocks per (sequence, kv head, group of 16 query heads)
(``choose_splits``: about two waves of the card's SMs, each split at least
one tile of ``tile_slots`` slots), streams its tiles through a ``cp.async``
ring, multiplies on the tensor cores (``mma.sync``) in bf16 and on CUDA
cores in float32, and merges the splits' partial softmax states in a fixed
order inside the same launch; the source says what bounds it.  The
wrapper owns the counters and partials the split merge uses, and runs its
checks once per call signature (``_build.checked_once``), so that a call
inside a captured CUDA graph allocates nothing of its own but its output
(``kernels._graph``).
``decode_attention_split_reference`` is that split rule in plain PyTorch,
for the tests.  For tensors on the CPU the wrapper computes
``decode_attention_reference``, the plain PyTorch version and the twin of
``repro.kernels.ref.decode_attention_ref``.  The TPU kernel's
``blk_s``/``interpret`` have no meaning here.

Layouts.  The caches are ``[B, KV, S, D]`` with any strides whose last is
1, so the model passes its ``[B, S, KV, D]`` cache as a transposed view
and nothing is copied; ``cache_len`` and ``positions`` may be broadcast
over the batch (batch stride 0).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels._build import counted
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS, NEG_INF

MAX_GROUP = 48          # query heads per kv head the kernel takes
ROW_GROUP = 16          # query heads per block: one m16 tile
WAVES = 2               # blocks per SM the split rule aims for
MAX_SPLITS = 16         # one block merges them all, one after another


def tile_slots(dtype: torch.dtype, head_dim: int) -> int:
    """Cache slots per tile of the kernel's (dtype, D) instantiation (the
    ``BK`` of ``Cfg`` in ``csrc/decode_attention.cu``)."""
    return 64 if dtype == torch.bfloat16 or head_dim <= 64 else 32


def split_ranges(S: int, n_splits: int, tile: int) -> list:
    """The slot ranges ``[lo, hi)`` the kernel's splits take: whole tiles,
    ``ceil(tiles / n)`` per split, so that no split is empty (``n_splits``
    is capped to the tile count and may come out smaller)."""
    tiles = -(-S // tile)
    per = -(-tiles // max(1, min(n_splits, tiles)))
    return [(lo, min(S, lo + per * tile)) for lo in range(0, S, per * tile)]


def choose_splits(blocks: int, S: int, tile: int, n_sm: int) -> int:
    """Splits per (sequence, kv head, row group): enough for ``blocks``
    such groups to cover about ``WAVES`` waves of ``n_sm`` SMs, at most
    one per tile and at most ``MAX_SPLITS``."""
    return max(1, min(-(-S // tile), -(-WAVES * n_sm // blocks), MAX_SPLITS))


def decode_attention_reference(q, k_cache, v_cache, cache_len, positions, *,
                               window: Optional[int] = None,
                               with_lse: bool = False):
    """Plain PyTorch, term for term ``repro.kernels.ref.decode_attention_ref``:
    q [B, H, D]; caches [B, KV, S, D]; cache_len [B]; positions [B, S].
    With ``with_lse`` also the float32 log-sum-exp [B, H] of each row's
    masked, scaled scores."""
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
    o = o.reshape(B, H, D).to(q.dtype)
    if not with_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(B, H)


def decode_attention_split_reference(q, k_cache, v_cache, cache_len,
                                     positions, *, n_splits: int,
                                     window: Optional[int] = None,
                                     tile: Optional[int] = None):
    """The kernel's split rule in plain PyTorch (used by the tests): each
    split of ``split_ranges`` keeps its own (max m, sum l, output o) over
    its slots, masked scores at -1e30, and the splits are merged in order
    with a log-sum-exp rescale.  ``tile`` defaults to the kernel's."""
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    tile = tile or tile_slots(q.dtype, D)
    qg = q.reshape(B, KV, H // KV, D).float()
    s = torch.einsum("bgrd,bgsd->bgrs", qg, k_cache.float()) / (D ** 0.5)
    clen = cache_len[:, None]
    valid = (positions >= 0) & (positions < clen)
    if window is not None:
        valid &= positions > clen - 1 - window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    parts = []
    for lo, hi in split_ranges(S, n_splits, tile):
        m = s[..., lo:hi].amax(-1, keepdim=True)
        p = torch.exp(s[..., lo:hi] - m)
        parts.append((m, p.sum(-1, keepdim=True), torch.einsum(
            "bgrs,bgsd->bgrd", p, v_cache[:, :, lo:hi].float())))
    mg = torch.stack([m for m, _, _ in parts]).amax(0)
    num, den = 0.0, 0.0
    for m, l_, o in parts:                      # split order
        w = torch.exp(m - mg)
        num, den = num + w * o, den + w * l_
    return (num / den).reshape(B, H, D).to(q.dtype)


def _check(q, k_cache, v_cache, cache_len, positions, window) -> bool:
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
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]):
            raise ValueError("kernel takes a unit last stride and other "
                             "strides of whole 16-byte rows")
    if S > 1 and positions.stride(1) != 1:
        raise ValueError("the rows of positions must be contiguous")
    return True


_CHECKED: dict = {}         # call signature -> True


def _checked(q, k_cache, v_cache, cache_len, positions, window) -> None:
    """The window on every call, then ``_check`` once per call signature
    (``_build.checked_once``), then the data's 16-byte alignment."""
    from repro_torch.kernels._build import checked_once
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    checked_once(_CHECKED, lambda: _check(q, k_cache, v_cache, cache_len,
                                          positions, window),
                 q, k_cache, v_cache, cache_len, positions)
    if (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError("kernel takes 16-byte aligned q and caches")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention_bhd(q, k_cache, v_cache, cache_len, positions, *,
                         window: Optional[int] = None,
                         with_lse: bool = False):
    """q: [B, H, D]; caches: [B, KV, S, D] (float32 or bfloat16);
    cache_len: [B] i32; positions: [B, S] i32 (absolute position per slot,
    -1 = never valid).  Returns [B, H, D] in q's dtype; with ``with_lse``
    (out, lse), ``lse`` the float32 log-sum-exp [B, H] of each row's
    masked, scaled scores, by which results over disjoint slot ranges
    merge.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    split as ``choose_splits`` says, and add one to
    ``decode_attention_bhd.launches``; meta tensors give empty results
    and book the kernel's cost (``_meta_call``)."""
    if q.device.type == "meta":
        return _meta_call(q, k_cache, with_lse)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, cache_len,
                                          positions, window=window,
                                          with_lse=with_lse)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _launch(q, k_cache, v_cache, cache_len, positions, window=window,
                   with_lse=with_lse)


def _meta_call(q, k_cache, with_lse):
    """``decode_attention_bhd`` on ``meta`` tensors (the dry-run's trace,
    where nothing runs): empty results, and the kernel's cost booked by
    ``_build.on_meta``: 4 D operations a slot and head (it scores every
    slot, masked or not), q, the caches, lengths and positions read and
    the output (and lse) written once."""
    from repro_torch.kernels._build import on_meta
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    on_meta(4 * D * H * B * S,
            q.element_size() * 2 * B * (H + S * KV) * D + 4 * B * (1 + S)
            + (4 * B * H if with_lse else 0))
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if not with_lse:
        return out
    return out, torch.empty((B, H), dtype=torch.float32, device=q.device)


def _launch(q, k_cache, v_cache, cache_len, positions, *,
            window: Optional[int] = None, n_splits: Optional[int] = None,
            with_lse: bool = False):
    """Launch the kernel on CUDA tensors.  ``n_splits`` (None: the rule of
    ``choose_splits``) lets the tests reach split counts the rule does not
    pick at their shapes."""
    _checked(q, k_cache, v_cache, cache_len, positions, window)
    from repro_torch.kernels._build import (
        launch, load_library, split_scratch,
    )
    lib = load_library()
    B, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    blocks = B * KV * -(-(H // KV) // ROW_GROUP)
    index = q.get_device()
    if n_splits is None:
        n_splits = choose_splits(blocks, S, tile_slots(q.dtype, D),
                                 _sm_count(index))
    counters, part = split_scratch("B2", q.device, blocks,
                                   blocks * n_splits * ROW_GROUP * (D + 2)
                                   if n_splits > 1 else 0)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if with_lse else None)
    err = launch(
        index, lib.da_launch, DTYPES[q.dtype], q.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
        positions.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), part.data_ptr(),
        counters.data_ptr(), B, H, KV, S, D, int(n_splits), q.stride(0),
        q.stride(1), *k_cache.stride()[:3], *v_cache.stride()[:3],
        cache_len.stride(0), positions.stride(0),
        -1 if window is None else int(window),
        ctypes.c_float(math.log2(math.e) / D ** 0.5))
    if err:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    decode_attention_bhd.launches += 1
    return out if lse is None else (out, lse)


counted(decode_attention_bhd)
