"""Paged decode attention over a block-indexed KV cache, on Hopper.

The port of ``src/repro/kernels/paged_decode_attention.py``.  One new
query token per sequence attends its ``seq_len`` cached slots, which live
in a shared pool of pages ``[KV, N, block, D]`` addressed through a block
table; the gather happens inside the kernel, so sequences share prefix
pages and nothing is recompacted between steps.

``paged_decode_attention`` is the wrapper.  For tensors on the card it
launches the hand-written CUDA kernel in ``csrc/paged_decode_attention.cu``
(one thread block per (sequence, kv head), pages staged through shared
memory, fp32 online softmax; the source says what bounds it) and raises on
anything the kernel does not take.  For tensors on the CPU it computes
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

import ctypes

import torch

NEG_INF = -1e30
_THREADS = 128          # threads per block in the CUDA kernel
_MAX_ACC = 16           # accumulator registers per thread: r * D <= 2048
_MAX_SMEM = 232_448     # bytes of shared memory one block may use on H100
HEAD_DIMS = (16, 32, 64, 128)


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
    if D not in HEAD_DIMS or r * D > _MAX_ACC * _THREADS:
        raise ValueError(f"kernel takes D in {HEAD_DIMS} and r*D <= "
                         f"{_MAX_ACC * _THREADS}, got D={D} r={r}")
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
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("page pools must be 16-byte aligned")
    return quantized


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                           k_scales=None, v_scales=None):
    """q: [B, H, D] f32; k/v_pages: [KV, N, block, D] f32 or int8;
    block_tables: [B, nb] i32 page ids (-1 = padding); seq_lens: [B] i32
    valid cache length per sequence (0 = inert row); k/v_scales: [KV, N]
    f32, required iff the pools are int8.  Returns [B, H, D] f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    and add one to ``paged_decode_attention.launches``."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pages, v_pages, block_tables, seq_lens,
            k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    quantized = _check(q, k_pages, v_pages, block_tables, seq_lens,
                       k_scales, v_scales)
    from repro_torch.kernels._build import load_library
    lib = load_library()
    B, H, D = q.shape
    KV, N, block, _ = k_pages.shape
    smem = lib.pda_smem_bytes(H // KV, block, D)
    if smem > _MAX_SMEM:
        raise ValueError(f"block={block} D={D} needs {smem} B of shared "
                         f"memory, more than {_MAX_SMEM}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pda_launch(
            int(quantized), q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(),
            k_scales.data_ptr() if quantized else None,
            v_scales.data_ptr() if quantized else None,
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, H, KV, N, block, D, block_tables.shape[1],
            ctypes.c_float(1.0 / D ** 0.5), stream)
    if err:
        raise RuntimeError(f"paged_decode_attention launch failed: "
                           f"cudaError {err}")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
