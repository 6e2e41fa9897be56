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

Gradient.  The JAX package has no backward kernel: it differentiates its
jnp attention.  The port's models call B3 on the training path, so
``FlashAttentionFn`` gives it one.  Its forward pass asks the kernel for
each row's float32 log-sum-exp as well (``with_lse``; inference calls do
not), and its backward pass is ``flash_attention_bwd``: on the card the
port's own hand-written kernels (dQ, then dK and dV, no atomics), chosen
by ``bwd_route`` as the forward's by ``route``: bfloat16 at ``D`` 64 and
128 on the tensor cores (``csrc/flash_attention_bwd_wgmma.cu``), the rest
on CUDA cores (``csrc/flash_attention_bwd.cu``), counted in
``flash_attention_bwd.launches`` and ``launches_by_route``; on the CPU
``flash_attention_bwd_reference``, their formulas in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels._build import counted

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
WGMMA_HEAD_DIMS = (64, 128, 256)    # bf16 head dims of the tensor-core kernel
# bf16 head dims of the tensor-core backward: at 256 its dK and dV
# accumulators (256 fp32 a thread) do not fit the registers
WGMMA_BWD_HEAD_DIMS = (64, 128)


def route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernel takes a call on the card: ``"wgmma"`` for bfloat16 at
    the head dims of ``WGMMA_HEAD_DIMS``, else ``"simt"``."""
    return ("wgmma" if dtype == torch.bfloat16
            and head_dim in WGMMA_HEAD_DIMS else "simt")


def bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """Which kernels take a backward call on the card: ``"wgmma"`` for
    bfloat16 at the head dims of ``WGMMA_BWD_HEAD_DIMS``, else
    ``"simt"``."""
    return ("wgmma" if dtype == torch.bfloat16
            and head_dim in WGMMA_BWD_HEAD_DIMS else "simt")


def _masked_scores(q, k, causal: bool, window: Optional[int]):
    """[BH, S, S] float32 scores of q [BH, S, D] against k [BKV, S, D] (kv
    heads repeated to the query heads), scaled by 1/sqrt(D), masked
    entries at -1e30, as ``repro.kernels.ref.flash_attention_ref``."""
    BH, S, D = q.shape
    r = BH // k.shape[0]
    kx = torch.repeat_interleave(k, r, dim=0).float()
    s = torch.einsum("hqd,hkd->hqk", q.float(), kx) / (D ** 0.5)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= kpos > qpos - window
    return torch.where(mask[None], s, torch.full_like(s, NEG_INF))


def _flat(*ts):
    """[B, H, S, D] tensors as [B * H, S, D] (3-D ones as they are)."""
    return [t.reshape(-1, *t.shape[2:]) if t.dim() == 4 else t for t in ts]


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              window: Optional[int] = None):
    """Plain PyTorch, term for term ``repro.kernels.ref.flash_attention_ref``:
    q [BH, S, D] (or [B, H, S, D]); k, v [BKV, S, D] (or [B, KV, S, D])."""
    shape = q.shape
    q, k, v = _flat(q, k, v)
    r = q.shape[0] // k.shape[0]
    vx = torch.repeat_interleave(v, r, dim=0).float()
    a = torch.softmax(_masked_scores(q, k, causal, window), dim=-1)
    return torch.einsum("hqk,hkd->hqd", a, vx).to(q.dtype).reshape(shape)


def flash_attention_lse_reference(q, k, *, causal: bool = True,
                                  window: Optional[int] = None):
    """The log-sum-exp of each query row's masked, scaled scores: float32
    [BH, S] (or [B, H, S]), what the kernels write beside the output for
    the backward pass (``lse`` of ``flash_attention_bhsd``)."""
    shape = q.shape[:-1]
    q, k = _flat(q, k)
    return torch.logsumexp(_masked_scores(q, k, causal, window),
                           dim=-1).reshape(shape)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal: bool = True,
                                  window: Optional[int] = None):
    """Plain PyTorch of the backward pass, the formulas the kernels of
    ``csrc/flash_attention_bwd.cu`` compute, in float32: with
    ``P = exp(S * scale - lse)`` (masked entries 0), ``dP = dO V^T`` and
    ``delta = rowsum(dO * O)``,

        dV = P^T dO,  dS = P * (dP - delta),  dQ = dS K * scale,
        dK = dS^T Q * scale,

    dK and dV summed over the ``r`` query heads of each kv head.  Shapes
    as ``flash_attention_reference``'s, ``lse`` [BH, S] (or [B, H, S])
    float32; returns (dq, dk, dv) in the inputs' dtype and shapes."""
    shapes = (q.shape, k.shape, v.shape)
    qf, kf, vf, of, dof = (t.float() for t in _flat(q, k, v, o, do))
    BH, S, D = qf.shape
    BKV = kf.shape[0]
    r = BH // BKV
    scale = 1.0 / D ** 0.5
    kx = torch.repeat_interleave(kf, r, dim=0)
    vx = torch.repeat_interleave(vf, r, dim=0)
    p = torch.exp(_masked_scores(qf, kf, causal, window)
                  - lse.float().reshape(BH, S)[..., None])
    dv = torch.einsum("hqk,hqd->hkd", p, dof).reshape(BKV, r, S, D).sum(1)
    dp = torch.einsum("hqd,hkd->hqk", dof, vx)
    delta = (dof * of).sum(-1)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("hqk,hkd->hqd", ds, kx) * scale
    dk = (torch.einsum("hqk,hqd->hkd", ds, qf) * scale
          ).reshape(BKV, r, S, D).sum(1)
    return tuple(g.to(t.dtype).reshape(shape) for g, t, shape in
                 zip((dq, dk, dv), (q, k, v), shapes))


def _as4(t: torch.Tensor) -> torch.Tensor:
    return t.unsqueeze(0) if t.dim() == 3 else t


def kept_pairs(S: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs of an S-token sequence that the mask keeps
    (``_masked_scores``' rule): the kernels' work is this many pairs."""
    if window is None or window >= S:
        return S * (S + 1) // 2 if causal else S * S
    w = window
    if causal:
        return w * (w + 1) // 2 + (S - w) * w
    return w * S + (S - 1 + w) * (S - w) // 2


def _meta_forward(q, k, causal, window, with_lse):
    """``flash_attention_bhsd`` on ``meta`` tensors (the dry-run's trace,
    where nothing runs): empty results, and the kernel's cost booked by
    ``_build.on_meta``: 4 D operations a kept pair and head, q, k, v read
    and the output (and lse) written once."""
    from repro_torch.kernels._build import on_meta
    B, H, S, D = _as4(q).shape
    KV = _as4(k).shape[1]
    on_meta(4 * D * H * B * kept_pairs(S, causal, window),
            q.element_size() * 2 * B * S * (H + KV) * D
            + (4 * B * H * S if with_lse else 0))
    out4 = _empty_like_input(q)
    out = out4 if q.dim() == 4 else out4[0]
    if not with_lse:
        return out
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    return out, (lse if q.dim() == 4 else lse[0])


def _meta_backward(q, k, v, causal, window):
    """``flash_attention_bwd`` on ``meta`` tensors: empty gradients, and
    the kernels' cost: 10 D operations a kept pair and head (the scores,
    P, dP, dS recomputed; dQ, dK, dV), q, k, v, o, do and lse read and
    dq, dk, dv written once."""
    from repro_torch.kernels._build import on_meta
    B, H, S, D = _as4(q).shape
    KV = _as4(k).shape[1]
    on_meta(10 * D * H * B * kept_pairs(S, causal, window),
            q.element_size() * 4 * B * S * (H + KV) * D + 4 * B * H * S)
    grads = [_empty_like_input(t) for t in (q, k, v)]
    return tuple(g if q.dim() == 4 else g[0] for g in grads)


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
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if not _rows_aligned(t):
            raise ValueError("kernel takes a unit last stride, other strides "
                             "of whole 16-byte rows and 16-byte aligned data")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Unit last stride, other strides whole 16-byte rows, 16-byte aligned
    data: what the kernels' 16-byte row loads take."""
    vec = 16 // t.element_size()           # elements per 16-byte load
    return (t.stride(-1) == 1 and not any(s % vec for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _empty_like_input(t: torch.Tensor) -> torch.Tensor:
    """An output for input ``t`` as a [B, ., S, D] tensor: contiguous for a
    [BH, S, D] input (with a unit batch axis in front), else laid out
    [B, S, ., D] and returned as a [B, ., S, D] view, the model's layout."""
    if t.dim() == 3:
        return torch.empty_like(t, memory_format=torch.contiguous_format
                                ).unsqueeze(0)
    B, H, S, D = t.shape
    return torch.empty((B, S, H, D), dtype=t.dtype,
                       device=t.device).transpose(1, 2)


def flash_attention_bhsd(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         with_lse: bool = False):
    """q: [BH, S, D] or [B, H, S, D]; k, v: [BKV, S, D] or [B, KV, S, D];
    float32 or bfloat16.  Returns q's shape and dtype; with ``with_lse``,
    (out, lse), ``lse`` the float32 log-sum-exp of each row's masked,
    scaled scores ([BH, S] or [B, H, S]), which the backward pass reads.

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    ``route(q.dtype, D)`` and add one to ``flash_attention_bhsd.launches``
    and to that route's count in ``launches_by_route``; meta tensors give
    empty results and book the kernel's cost (``_meta_forward``)."""
    if q.device.type == "meta":
        return _meta_forward(q, k, causal, window, with_lse)
    if q.device.type == "cpu":
        out = flash_attention_reference(q, k, v, causal=causal, window=window)
        if not with_lse:
            return out
        return out, flash_attention_lse_reference(q, k, causal=causal,
                                                  window=window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, window)
    from repro_torch.kernels._build import load_library
    lib = load_library()
    q4, k4, v4 = _as4(q), _as4(k), _as4(v)
    B, H, S, D = q4.shape
    KV = k4.shape[1]
    out4 = _empty_like_input(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    which = route(q.dtype, D)
    args = (q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out4.data_ptr(),
            B, H, KV, S, D, *q4.stride()[:3], *k4.stride()[:3],
            *v4.stride()[:3], *out4.stride()[:3], int(causal),
            -1 if window is None else int(window))
    p_lse = None if lse is None else lse.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which == "wgmma":        # exp2 scores: log2(e) folded in
            err = lib.fa_wgmma_launch(
                *args, ctypes.c_float(math.log2(math.e) / D ** 0.5), p_lse,
                stream)
        else:
            err = lib.fa_launch(DTYPES[q.dtype], *args,
                                ctypes.c_float(1.0 / D ** 0.5), p_lse, stream)
    if err:
        raise RuntimeError(f"flash_attention {which} launch failed: error "
                           f"{err}")
    flash_attention_bhsd.launches += 1
    flash_attention_bhsd.launches_by_route[which] += 1
    out = out4 if q.dim() == 4 else out4[0]
    if not with_lse:
        return out
    return out, (lse if q.dim() == 4 else lse[0])


counted(flash_attention_bhsd)
flash_attention_bhsd.launches_by_route = {"wgmma": 0, "simt": 0}


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None):
    """The backward pass of ``flash_attention_bhsd``: q, k, v, its output
    ``o`` and ``lse`` as the forward pass took and gave them, ``do`` the
    gradient of ``o`` (any strides).  Returns (dq, dk, dv) in q's, k's and
    v's shapes and dtype (for [B, ., S, D] inputs, [B, ., S, D] views of
    tensors laid out [B, S, ., D], as the model's activations are).

    CPU tensors take ``flash_attention_bwd_reference``; CUDA tensors
    launch the two kernels (dQ, then dK and dV) of
    ``bwd_route(q.dtype, D)``: ``csrc/flash_attention_bwd_wgmma.cu`` on
    the tensor cores, or ``csrc/flash_attention_bwd.cu`` on the CUDA
    cores; each call adds one to ``flash_attention_bwd.launches`` and to
    that route's count in ``launches_by_route``.  Meta tensors give empty
    gradients and book the kernels' cost (``_meta_backward``)."""
    if q.device.type == "meta":
        return _meta_backward(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                             window)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k, v, window)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != q.shape[:-1] or lse.dtype != torch.float32:
        raise ValueError(f"want lse {tuple(q.shape[:-1])} float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if not _rows_aligned(do):
        do = do.contiguous()
    if not _rows_aligned(o):
        raise ValueError("o must have the layout the forward pass wrote")
    from repro_torch.kernels._build import load_library
    lib = load_library()
    q4, k4, v4, o4, do4 = (_as4(t) for t in (q, k, v, o, do))
    B, H, S, D = q4.shape
    KV = k4.shape[1]
    lse = lse.contiguous()
    dq4, dk4, dv4 = (_empty_like_input(t) for t in (q, k, v))
    # a dimension of size 1 takes the stride D: any stride is right for
    # it, and the tensor maps want whole 16-byte rows
    strides = (ctypes.c_int64 * 24)(*(
        s if n > 1 else D for t in (q4, k4, v4, o4, do4, dq4, dk4, dv4)
        for s, n in zip(t.stride()[:3], t.shape[:3])))
    which = bwd_route(q.dtype, D)
    ptrs = (q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr(),
            do4.data_ptr(), lse.data_ptr())
    grads = (dq4.data_ptr(), dk4.data_ptr(), dv4.data_ptr())
    rest = (B, H, KV, S, D, strides, int(causal),
            -1 if window is None else int(window))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which == "wgmma":
            # each row's lse * log2(e) and delta, rows padded to a tile
            stats = torch.empty((B * H, 2, lib.fab_wgmma_rows(S)),
                                dtype=torch.float32, device=q.device)
            err = lib.fab_wgmma_launch(
                *ptrs, stats.data_ptr(), *grads, *rest,
                ctypes.c_float(math.log2(math.e) / D ** 0.5),
                ctypes.c_float(1.0 / D ** 0.5), stream)
        else:
            delta = torch.empty((B, H, S), dtype=torch.float32,
                                device=q.device)
            err = lib.fab_launch(DTYPES[q.dtype], *ptrs, delta.data_ptr(),
                                 *grads, *rest,
                                 ctypes.c_float(1.0 / D ** 0.5), stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd {which} launch failed: "
                           f"error {err}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_route[which] += 1
    if q.dim() == 3:
        return dq4[0], dk4[0], dv4[0]
    return dq4, dk4, dv4


counted(flash_attention_bwd)
flash_attention_bwd.launches_by_route = {"wgmma": 0, "simt": 0}


class FlashAttentionFn(torch.autograd.Function):
    """B3 with a gradient: the forward pass is ``flash_attention_bhsd``
    (which also writes each row's log-sum-exp), the backward pass
    ``flash_attention_bwd``, both by the tensors' device: the kernels on
    the card, the plain versions on the CPU.  q, k, v and the output are
    kept for the backward pass, which recomputes the probabilities from
    ``lse``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        o, lse = flash_attention_bhsd(q, k, v, causal=causal, window=window,
                                      with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None
