"""The Mamba-1 selective scan, on Hopper.

The port of ``src/repro/kernels/mamba_scan.py`` (``mamba1_scan``).  Per
sequence and channel ``d``, sequentially over time, in float32:

    h_t[n] = exp(dt_t * A[d, n]) * h_{t-1}[n] + dt_t * x_t * B_t[n]
    y_t    = sum_n C_t[n] * h_t[n]

without the D-skip term, which the caller adds (``models.ssm.mamba1_mix``).
The TPU kernel starts from zero and returns only ``y``; this one also
takes an optional initial state ``h0`` and returns the final state
``h_last``, which prefill needs to fill the cache and decode to step.
With ``h0 = None`` its ``y`` is the TPU kernel's.  ``h_last`` may be
written into a given tensor, ``h0`` itself included, so that a decode step
advances a cache entry in place.

``mamba1_scan`` is the wrapper.  For tensors on the card it launches the
hand-written CUDA kernel in ``csrc/mamba_scan.cu`` (each channel's N
states split over N / 8 lanes of a warp, in registers; time walked in
tiles that stream through a ``cp.async`` ring in shared memory; the
source says what bounds it) and raises on what the kernel does not take.
The checks run once per call signature (shapes, strides, dtypes,
devices) and are looked up after that; the pointers' alignment is
checked on every call.  For tensors on
the CPU it computes ``mamba1_scan_reference``, the plain PyTorch version
and the twin of ``repro.kernels.ref.mamba1_scan_ref``.  The TPU kernel's
``blk_d``/``interpret`` have no meaning here.
"""
from __future__ import annotations

import torch

STATE_SIZES = (8, 16, 32, 64)       # d_state values the kernel is built for


def mamba1_scan_reference(x, dt, Bt, Ct, A, h0=None):
    """Plain PyTorch, term for term ``repro.kernels.ref.mamba1_scan_ref``,
    plus the initial and final state: x, dt [B, T, Di]; Bt, Ct [B, T, N];
    A [Di, N]; h0 [B, Di, N] or None (zeros).  Returns (y [B, T, Di],
    h_last [B, Di, N]), float32."""
    B, T, Di = x.shape
    N = Bt.shape[-1]
    h = (torch.zeros((B, Di, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys = []
    for t in range(T):
        da = torch.exp(dt[:, t, :, None] * A[None])              # [B, Di, N]
        h = h * da + (dt[:, t] * x[:, t])[:, :, None] * Bt[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Ct[:, t]))
    return torch.stack(ys, 1), h


def _check(x, dt, Bt, Ct, A, h0, h_out=None) -> None:
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"want x, dt [B, T, Di]; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}")
    B, T, Di = x.shape
    if Bt.dim() != 3 or Bt.shape[:2] != (B, T) or Ct.shape != Bt.shape:
        raise ValueError(f"want Bt, Ct [B, T, N] for x {tuple(x.shape)}; got "
                         f"{tuple(Bt.shape)}, {tuple(Ct.shape)}")
    N = Bt.shape[2]
    if N not in STATE_SIZES:
        raise ValueError(f"kernel takes N in {STATE_SIZES}, got {N}")
    if tuple(A.shape) != (Di, N):
        raise ValueError(f"want A [{Di}, {N}], got {tuple(A.shape)}")
    for name, h in (("h0", h0), ("h_out", h_out)):
        if h is not None and tuple(h.shape) != (B, Di, N):
            raise ValueError(f"want {name} [{B}, {Di}, {N}], got "
                             f"{tuple(h.shape)}")
    if h_out is not None and not h_out.is_contiguous():
        raise ValueError("the kernel writes h_out as one contiguous block")
    if min(B, T, Di) < 1:
        raise ValueError(f"empty scan: B={B} T={T} Di={Di}")
    tensors = [t for t in (x, dt, Bt, Ct, A, h0, h_out) if t is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the scan takes float32 tensors, got "
                        + ", ".join(str(t.dtype) for t in tensors))
    if any(t.device != x.device for t in tensors):
        raise ValueError("the scan's tensors lie on different devices")


_CHECKED: dict = {}         # signature -> Bt's and Ct's (batch, time) strides


def _checked(x, dt, Bt, Ct, A, h0, h_out) -> tuple:
    """``_check`` once per call signature (``_build.checked_once``).
    Returns the element strides (batch, time) of Bt and Ct."""
    from repro_torch.kernels._build import checked_once

    def check():
        _check(x, dt, Bt, Ct, A, h0, h_out)
        return (*Bt.stride()[:2], *Ct.stride()[:2])
    return checked_once(_CHECKED, check, x, dt, Bt, Ct, A, h0, h_out)


def mamba1_scan(x, dt, Bt, Ct, A, h0=None, h_out=None):
    """x, dt: [B, T, Di]; Bt, Ct: [B, T, N]; A: [Di, N]; h0: [B, Di, N] or
    None; all float32.  Returns (y [B, T, Di], h_last [B, Di, N]);
    ``h_last`` is ``h_out`` when one is given (contiguous [B, Di, N]; it
    may be ``h0``), else a new tensor.

    CPU tensors take the plain version; CUDA tensors launch the kernel and
    add one to ``mamba1_scan.launches``.  B_t and C_t may be strided slices
    of one projection (unit last stride); other inputs are made
    contiguous."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no kernel for device {x.device}")
        y, h = mamba1_scan_reference(x, dt, Bt, Ct, A, h0)
        return y, (h if h_out is None else h_out.copy_(h))
    if Bt.stride(-1) != 1:
        Bt = Bt.contiguous()
    if Ct.stride(-1) != 1:
        Ct = Ct.contiguous()
    strides = _checked(x, dt, Bt, Ct, A, h0, h_out)
    from repro_torch.kernels._build import launch, load_library
    lib = load_library()
    x, dt, A = x.contiguous(), dt.contiguous(), A.contiguous()
    h0 = None if h0 is None else h0.contiguous()
    B, T, Di = x.shape
    N = A.shape[1]
    h_last = (torch.empty((B, Di, N), dtype=torch.float32, device=x.device)
              if h_out is None else h_out)
    p_a, p_h = A.data_ptr(), h_last.data_ptr()
    p_h0 = 0 if h0 is None else h0.data_ptr()
    if (p_a | p_h0 | p_h) % 16:
        raise ValueError("the kernel reads A and h0 rows and writes h_last "
                         "rows as 16-byte vectors: their data must be "
                         "16-byte aligned")
    y = torch.empty_like(x)
    err = launch(x.get_device(), lib.ms_launch, x.data_ptr(), dt.data_ptr(),
                 Bt.data_ptr(), Ct.data_ptr(), p_a, p_h0 or None,
                 y.data_ptr(), p_h, B, T, Di, N, *strides)
    if err:
        raise RuntimeError(f"mamba1_scan launch failed: cudaError {err}")
    mamba1_scan.launches += 1
    return y, h_last


mamba1_scan.launches = 0
