"""Paged decode attention over a block-indexed KV cache, on Hopper.

The port of ``src/repro/kernels/paged_decode_attention.py``.  One new
query token per sequence attends its ``seq_len`` cached slots, which live
in a shared pool of pages ``[KV, N, block, D]`` addressed through a block
table; the gather happens inside the kernel, so sequences share prefix
pages and nothing is recompacted between steps.

``paged_decode_attention`` is the wrapper.  For tensors on the card it
launches the hand-written CUDA kernel in ``csrc/paged_decode_attention.cu``
and raises on anything the kernel does not take.  The kernel splits each
row's pages over ``n_splits`` blocks per (sequence, kv head, group of 8
query heads) (``choose_splits``: enough blocks for every SM to hold as
many as it can, whole pages per split, at most 16), streams the slots through a ``cp.async``
ring in the pool's own type (int8 stays one byte until it is read),
multiplies in fp32 on CUDA cores, and merges the splits' partial softmax
states in a fixed order inside the same launch; the source says what
bounds it.  ``paged_decode_attention_split_reference`` is that split rule
in plain PyTorch, for the tests.  The checks run once per call signature
(shapes, strides, dtypes, devices) and are looked up after that.  For tensors on the CPU it computes
``paged_decode_attention_reference``, the plain PyTorch version, which the
CPU tests compare with the JAX package and which ``chip_smoke.py`` holds
the kernel against on the card.  The TPU kernel's ``pool_in_vmem`` and
``vmem_budget_bytes`` choose between VMEM and HBM residency of the pool;
Hopper has no such choice (the pool lives in device memory and pages pass
through shared memory), so the port has neither argument.

Semantics shared by both versions (and by the TPU kernel):

* scores are scaled by ``1/sqrt(D)``;
* a ``-1`` table entry is clamped to page 0 and its slots are masked;
* masked scores are ``-1e30``, so a row with no valid slot (``seq_len``
  0) returns the uniform mean of V over every gathered slot, not zeros;
* int8 pages are dequantized as ``x * scale / 127`` with one scale per
  (kv head, page).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels._build import counted

NEG_INF = -1e30
MAX_GROUP_DIM = 2048    # r * D the kernel takes (r = H / KV)
ROW_GROUP = 8           # query heads per block
_MAX_SMEM = 232_448     # bytes of shared memory one block may use on H100
HEAD_DIMS = (16, 32, 64, 128)
WAVES = 2               # blocks per SM where the occupancy is not known
MAX_SPLITS = 16         # one block merges them all, one after another


def dequantize_pages(pages: torch.Tensor,
                     scales: torch.Tensor) -> torch.Tensor:
    """int8 pages [KV, N, block, D] + per-page scales [KV, N] -> fp32."""
    return pages.to(torch.float32) * (scales[:, :, None, None] / 127.0)


def paged_decode_attention_reference(q, k_pages, v_pages, block_tables,
                                     seq_lens, *, k_scales=None,
                                     v_scales=None):
    """Gather-then-softmax in plain PyTorch, term for term the JAX
    package's ``paged_decode_attention_reference``."""
    if k_scales is not None:
        k_pages = dequantize_pages(k_pages, k_scales)
        v_pages = dequantize_pages(v_pages, v_scales)
    B, H, D = q.shape
    KV, N, block, _ = k_pages.shape
    r = H // KV
    nb_max = block_tables.shape[1]
    pages = block_tables.long().clamp(0, N - 1)                  # [B, nb]
    k = k_pages[:, pages]                           # [KV, B, nb, block, D]
    v = v_pages[:, pages]
    k = k.movedim(1, 0).reshape(B, KV, nb_max * block, D)
    v = v.movedim(1, 0).reshape(B, KV, nb_max * block, D)
    qg = q.reshape(B, KV, r, D)
    s = torch.einsum("bgrd,bgsd->bgrs", qg, k) / (D ** 0.5)
    pos = torch.arange(nb_max * block, device=q.device)[None, :]
    valid = (pos < seq_lens[:, None]) & torch.repeat_interleave(
        block_tables >= 0, block, dim=1)
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    # softmax that tolerates fully-masked (seq_len == 0) rows
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bgrs,bgsd->bgrd",
                       p / torch.where(l == 0, torch.ones_like(l), l), v)
    return out.reshape(B, H, D).to(q.dtype)


def pages_walked(block_tables, seq_lens, block: int) -> torch.Tensor:
    """Pages each row's kernel blocks walk: ``ceil(seq_len / block)`` (at
    most nb) when one of those pages is real, else all nb, so that a row
    with no valid slot averages V over every gathered slot."""
    nb = block_tables.shape[1]
    need = ((seq_lens.long().clamp(min=0) + block - 1) // block).clamp(max=nb)
    j = torch.arange(nb, device=block_tables.device)
    real = ((j[None, :] < need[:, None]) & (block_tables >= 0)).any(1)
    return torch.where(real, need, torch.full_like(need, nb))


def split_ranges(nb: int, n_splits: int) -> list:
    """The page ranges ``[lo, hi)`` of the kernel's splits: whole pages,
    ``ceil(nb / n)`` per split, so that no split is empty of table
    entries (``n_splits`` is capped to nb and may come out smaller)."""
    per = -(-nb // max(1, min(n_splits, nb)))
    return [(lo, min(nb, lo + per)) for lo in range(0, nb, per)]


def choose_splits(blocks: int, nb: int, n_sm: int,
                  per_sm: int = WAVES) -> int:
    """Splits per (sequence, kv head, row group): as many as let ``blocks``
    such groups fill the ``per_sm`` blocks that each of ``n_sm`` SMs
    holds (the kernel's occupancy; ``WAVES`` where it is not known), at
    most one per page and at most ``MAX_SPLITS``."""
    return max(1, min(nb, max(per_sm, 1) * n_sm // blocks, MAX_SPLITS))


def paged_decode_attention_split_reference(q, k_pages, v_pages,
                                           block_tables, seq_lens, *,
                                           n_splits: int, k_scales=None,
                                           v_scales=None):
    """The kernel's split rule in plain PyTorch (used by the tests): each
    split of ``split_ranges`` keeps its own (max m, sum l, output o) over
    the slots of its pages that the row walks (``pages_walked``; an empty
    split has m = -inf, l = 0), masked scores at -1e30, and the splits are
    merged in order with a log-sum-exp rescale."""
    if k_scales is not None:
        k_pages = dequantize_pages(k_pages, k_scales)
        v_pages = dequantize_pages(v_pages, v_scales)
    B, H, D = q.shape
    KV, N, block, _ = k_pages.shape
    nb = block_tables.shape[1]
    pages = block_tables.long().clamp(0, N - 1)
    k = k_pages[:, pages].movedim(1, 0).reshape(B, KV, nb * block, D)
    v = v_pages[:, pages].movedim(1, 0).reshape(B, KV, nb * block, D)
    s = torch.einsum("bgrd,bgsd->bgrs", q.reshape(B, KV, H // KV, D),
                     k) / (D ** 0.5)
    pos = torch.arange(nb * block, device=q.device)[None, :]
    valid = (pos < seq_lens[:, None]) & torch.repeat_interleave(
        block_tables >= 0, block, dim=1)
    walked = pos < (pages_walked(block_tables, seq_lens, block)
                    * block)[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    s = torch.where(walked[:, None, None, :], s,
                    torch.full_like(s, -math.inf))
    parts = []
    for lo, hi in split_ranges(nb, n_splits):
        sl = s[..., lo * block:hi * block]
        m = sl.amax(-1, keepdim=True)
        p = torch.exp(sl - torch.where(m == -math.inf, 0.0, m))
        parts.append((m, p.sum(-1, keepdim=True), torch.einsum(
            "bgrs,bgsd->bgrd", p, v[:, :, lo * block:hi * block])))
    mg = torch.stack([m for m, _, _ in parts]).amax(0)
    num, den = 0.0, 0.0
    for m, l_, o in parts:                      # split order
        w = torch.exp(m - mg)
        num, den = num + w * o, den + w * l_
    return (num / den).reshape(B, H, D).to(q.dtype)


def _check(q, k_pages, v_pages, block_tables, seq_lens, k_scales,
           v_scales) -> bool:
    """Validate a kernel call; returns whether the pools are int8."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("want q [B, H, D] and pages [KV, N, block, D]")
    B, H, D = q.shape
    KV, N, block, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"page shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if KV < 1 or H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    r = H // KV
    if D not in HEAD_DIMS or r * D > MAX_GROUP_DIM:
        raise ValueError(f"kernel takes D in {HEAD_DIMS} and r*D <= "
                         f"{MAX_GROUP_DIM}, got D={D} r={r}")
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or block_tables.shape[1] < 1 or tuple(seq_lens.shape) != (B,)):
        raise ValueError("want block_tables [B, nb>=1] and seq_lens [B]")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_tables and seq_lens must be int32")
    quantized = k_pages.dtype == torch.int8
    if not quantized and k_pages.dtype != torch.float32:
        raise TypeError(f"pages must be float32 or int8, got {k_pages.dtype}")
    if v_pages.dtype != k_pages.dtype:
        raise TypeError("k_pages and v_pages differ in dtype")
    tensors = [q, k_pages, v_pages, block_tables, seq_lens]
    if quantized:
        if k_scales is None or v_scales is None:
            raise ValueError("int8 pages need k_scales/v_scales [KV, N]")
        for sc in (k_scales, v_scales):
            if tuple(sc.shape) != (KV, N) or sc.dtype != torch.float32:
                raise ValueError("scales must be float32 [KV, N]")
        tensors += [k_scales, v_scales]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("kernel takes contiguous tensors only")
    return quantized


_CHECKED: dict = {}         # call signature -> whether the pools are int8


def _checked(q, k_pages, v_pages, block_tables, seq_lens, k_scales,
             v_scales) -> bool:
    """``_check`` once per call signature (``_build.checked_once``)."""
    from repro_torch.kernels._build import checked_once
    return checked_once(
        _CHECKED, lambda: _check(q, k_pages, v_pages, block_tables, seq_lens,
                                 k_scales, v_scales),
        q, k_pages, v_pages, block_tables, seq_lens, k_scales, v_scales)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _blocks_per_sm(index: int, quantized: bool, D: int, nb: int) -> int:
    """Blocks of the kernel one SM of card ``index`` holds, with a whole
    table's worth of shared memory (an upper bound for any split)."""
    from repro_torch.kernels._build import load_library
    with torch.cuda.device(index):
        return load_library().pda_blocks_per_sm(int(quantized), D, nb)


@functools.cache
def _smem_bytes(quantized: bool, D: int, pps: int) -> int:
    from repro_torch.kernels._build import load_library
    return load_library().pda_smem_bytes(int(quantized), D, pps)


@functools.cache
def _split_plan(index: int, quantized: bool, B: int, H: int, KV: int,
                D: int, nb: int, n_splits: Optional[int]) -> tuple:
    """The split count a launch takes (``n_splits``, or the rule of
    ``choose_splits`` for None, capped to whole pages), the (sequence, kv
    head, row group) count and the partials' floats; raises when a split's
    table does not fit in shared memory."""
    groups = B * KV * -(-(H // KV) // ROW_GROUP)
    if n_splits is None:
        n_splits = choose_splits(groups, nb, _sm_count(index),
                                 _blocks_per_sm(index, quantized, D, nb))
    n_splits = len(split_ranges(nb, n_splits))
    pps = -(-nb // n_splits)
    smem = _smem_bytes(quantized, D, pps)
    if smem > _MAX_SMEM:
        raise ValueError(f"{pps} pages per split at D={D} need {smem} B of "
                         f"shared memory, more than {_MAX_SMEM}")
    return (n_splits, groups,
            groups * n_splits * ROW_GROUP * (D + 2) if n_splits > 1 else 0)


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                           k_scales=None, v_scales=None):
    """q: [B, H, D] f32; k/v_pages: [KV, N, block, D] f32 or int8;
    block_tables: [B, nb] i32 page ids (-1 = padding); seq_lens: [B] i32
    valid cache length per sequence (0 = inert row); k/v_scales: [KV, N]
    f32, required iff the pools are int8.  Returns [B, H, D] f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    split as ``choose_splits`` says, and add one to
    ``paged_decode_attention.launches``."""
    if not q.is_cuda:
        if q.device.type != "cpu":
            raise ValueError(f"no kernel for device {q.device}")
        return paged_decode_attention_reference(
            q, k_pages, v_pages, block_tables, seq_lens,
            k_scales=k_scales, v_scales=v_scales)
    return _launch(q, k_pages, v_pages, block_tables, seq_lens,
                   k_scales=k_scales, v_scales=v_scales)


def _launch(q, k_pages, v_pages, block_tables, seq_lens, *, k_scales=None,
            v_scales=None, n_splits: Optional[int] = None):
    """Launch the kernel on CUDA tensors.  ``n_splits`` (None: the rule of
    ``choose_splits``) lets the tests reach split counts the rule does not
    pick at their shapes."""
    quantized = _checked(q, k_pages, v_pages, block_tables, seq_lens,
                         k_scales, v_scales)
    from repro_torch.kernels._build import (
        launch, load_library, split_scratch,
    )
    lib = load_library()
    B, H, D = q.shape
    KV, N, block, _ = k_pages.shape
    nb = block_tables.shape[1]
    index = q.get_device()
    n_splits, groups, n_part = _split_plan(index, quantized, B, H, KV, D, nb,
                                           n_splits)
    counters, part = split_scratch("B1", q.device, groups, n_part)
    if (k_pages.data_ptr() | v_pages.data_ptr()) % 16:
        raise ValueError("page pools must be 16-byte aligned")
    out = torch.empty_like(q)
    err = launch(index, lib.pda_launch, int(quantized), q.data_ptr(),
                 k_pages.data_ptr(), v_pages.data_ptr(),
                 k_scales.data_ptr() if quantized else None,
                 v_scales.data_ptr() if quantized else None,
                 block_tables.data_ptr(), seq_lens.data_ptr(),
                 out.data_ptr(), part.data_ptr(), counters.data_ptr(), B, H,
                 KV, N, block, D, nb, n_splits,
                 math.log2(math.e) / D ** 0.5)
    if err:
        raise RuntimeError(f"paged_decode_attention launch failed: "
                           f"cudaError {err}")
    paged_decode_attention.launches += 1
    return out


counted(paged_decode_attention)
