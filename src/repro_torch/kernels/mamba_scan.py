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

Gradient.  The JAX package has no backward kernel: it differentiates its
chunked associative scan.  The port's Mamba-1 layers call B4 on the
training path, so ``MambaScanFn`` gives it one.  Its forward pass asks
``mamba1_scan`` for checkpoints as well (``with_checkpoints``: the state
at the start of every ``CKPT_STEPS`` steps, [B, ceil(T / 16), Di, N]
float32; inference does not ask, and the kernel then writes none), and
its backward pass is ``mamba1_scan_bwd``, which recomputes each chunk's
states from them: on the card the port's own hand-written kernels in
``csrc/mamba_scan_bwd.cu`` (counted in ``mamba1_scan_bwd.launches``), on
the CPU ``mamba1_scan_bwd_reference``, the same recurrence in plain
PyTorch.  With ``g_t`` the gradient reaching ``h_t`` and
``a_t = exp(dt_t A)``:

    g_T = C_T dy_T + dh_last,   g_t = C_t dy_t + a_{t+1} * g_{t+1}
    dC_t[n] = sum_d dy_t[d] h_t[d, n]
    dB_t[n] = sum_d g_t[d, n] dt_t[d] x_t[d]
    dx_t[d] = dt_t[d] sum_n g_t[d, n] B_t[n]
    ddt_t[d] = sum_n g_t[d, n] (A[d, n] a_t[d, n] h_{t-1}[d, n] + x_t[d] B_t[n])
    dA = sum_{b, t} g_t dt_t a_t h_{t-1},   dh0 = a_1 * g_1
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels._build import counted

STATE_SIZES = (8, 16, 32, 64)       # d_state values the kernel is built for
# steps between checkpoints: the kernels' tile (csrc/scan_tile.cuh: kTT),
# which the library reports and ``_library`` holds to this
CKPT_STEPS = 16


def n_checkpoints(T: int) -> int:
    """Checkpoints of a T-step scan: one at the start of every
    ``CKPT_STEPS`` steps."""
    return -(-T // CKPT_STEPS)


def mamba1_scan_reference(x, dt, Bt, Ct, A, h0=None,
                          with_checkpoints: bool = False):
    """Plain PyTorch, term for term ``repro.kernels.ref.mamba1_scan_ref``,
    plus the initial and final state: x, dt [B, T, Di]; Bt, Ct [B, T, N];
    A [Di, N]; h0 [B, Di, N] or None (zeros).  Returns (y [B, T, Di],
    h_last [B, Di, N]), float32; with ``with_checkpoints``, also the state
    before steps 0, 16, 32, ... ([B, n_checkpoints(T), Di, N])."""
    B, T, Di = x.shape
    N = Bt.shape[-1]
    h = (torch.zeros((B, Di, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys, ckpt = [], []
    for t in range(T):
        if t % CKPT_STEPS == 0:
            ckpt.append(h)
        da = torch.exp(dt[:, t, :, None] * A[None])              # [B, Di, N]
        h = h * da + (dt[:, t] * x[:, t])[:, :, None] * Bt[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Ct[:, t]))
    if with_checkpoints:
        return torch.stack(ys, 1), h, torch.stack(ckpt, 1)
    return torch.stack(ys, 1), h


def mamba1_scan_bwd_reference(x, dt, Bt, Ct, A, h0, dy, dh_last):
    """Plain PyTorch of the scan's backward pass (the recurrence above),
    float32: the forward states recomputed and kept, then walked back.
    ``h0`` and ``dh_last`` [B, Di, N] may be None (zeros).  Returns (dx,
    ddt [B, T, Di], dB, dC [B, T, N], dA [Di, N], dh0 [B, Di, N])."""
    B, T, Di = x.shape
    N = Bt.shape[-1]
    h = (torch.zeros((B, Di, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    before, after, das = [], [], []          # h_{t-1}, h_t, a_t per step
    for t in range(T):
        before.append(h)
        da = torch.exp(dt[:, t, :, None] * A[None])
        h = h * da + (dt[:, t] * x[:, t])[:, :, None] * Bt[:, t, None, :]
        after.append(h)
        das.append(da)
    g = (torch.zeros_like(h) if dh_last is None
         else dh_last.float().clone())
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(Bt), torch.empty_like(Ct)
    dA = torch.zeros_like(A)
    for t in reversed(range(T)):
        g = g + Ct[:, t, None, :] * dy[:, t, :, None]
        h_prev, da = before[t], das[t]
        dC[:, t] = torch.einsum("bd,bdn->bn", dy[:, t], after[t])
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dt[:, t] * x[:, t])
        s1 = torch.einsum("bdn,bn->bd", g, Bt[:, t])
        gah = g * da * h_prev
        dx[:, t] = dt[:, t] * s1
        ddt[:, t] = (gah * A[None]).sum(-1) + x[:, t] * s1
        dA += (gah * dt[:, t, :, None]).sum(0)
        g = da * g
    return dx, ddt, dB, dC, dA, g


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


@functools.cache
def _library():
    """The kernels' library, once its checkpoint interval is known to be
    ``CKPT_STEPS``, by which the wrappers size the checkpoints."""
    from repro_torch.kernels._build import load_library
    lib = load_library()
    if lib.ms_ckpt_steps() != CKPT_STEPS:
        raise RuntimeError(f"the scan kernels checkpoint every "
                           f"{lib.ms_ckpt_steps()} steps, the wrappers "
                           f"every {CKPT_STEPS}")
    return lib


def _checked(x, dt, Bt, Ct, A, h0, h_out) -> tuple:
    """``_check`` once per call signature (``_build.checked_once``).
    Returns the element strides (batch, time) of Bt and Ct."""
    from repro_torch.kernels._build import checked_once

    def check():
        _check(x, dt, Bt, Ct, A, h0, h_out)
        return (*Bt.stride()[:2], *Ct.stride()[:2])
    return checked_once(_CHECKED, check, x, dt, Bt, Ct, A, h0, h_out)


def _meta_forward(x, Bt, h0, h_out, with_checkpoints):
    """``mamba1_scan`` on ``meta`` tensors (the dry-run's trace, where
    nothing runs): empty results (``h_out`` itself when given), and the
    kernel's cost booked by ``_build.on_meta``: 7 operations a (step,
    channel, state) and 1 a (step, channel); x, dt, B_t, C_t, A, h0 read
    and y, h_last and the checkpoints written once, all float32."""
    from repro_torch.kernels._build import on_meta
    B, T, Di = x.shape
    N = Bt.shape[-1]
    states = (2 if h0 is not None else 1) + (
        n_checkpoints(T) if with_checkpoints else 0)
    on_meta(7 * B * T * Di * N + B * T * Di,
            4 * (3 * B * T * Di + 2 * B * T * N + Di * N
                 + states * B * Di * N))
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((B, T, Di), **f32)
    h = torch.empty((B, Di, N), **f32) if h_out is None else h_out
    if not with_checkpoints:
        return y, h
    return y, h, torch.empty((B, n_checkpoints(T), Di, N), **f32)


def mamba1_scan(x, dt, Bt, Ct, A, h0=None, h_out=None, *,
                with_checkpoints: bool = False):
    """x, dt: [B, T, Di]; Bt, Ct: [B, T, N]; A: [Di, N]; h0: [B, Di, N] or
    None; all float32.  Returns (y [B, T, Di], h_last [B, Di, N]);
    ``h_last`` is ``h_out`` when one is given (contiguous [B, Di, N]; it
    may be ``h0``), else a new tensor.  With ``with_checkpoints``, also
    the state before steps 0, 16, 32, ... ([B, n_checkpoints(T), Di, N]
    float32), which the backward pass reads.

    CPU tensors take the plain version; CUDA tensors launch the kernel and
    add one to ``mamba1_scan.launches``; meta tensors give empty results
    and book the kernel's cost (``_meta_forward``).  B_t and C_t may be
    strided slices of one projection (unit last stride); other inputs are
    made contiguous."""
    if x.device.type == "meta":
        return _meta_forward(x, Bt, h0, h_out, with_checkpoints)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no kernel for device {x.device}")
        y, h, *ckpt = mamba1_scan_reference(x, dt, Bt, Ct, A, h0,
                                            with_checkpoints)
        return (y, h if h_out is None else h_out.copy_(h), *ckpt)
    if Bt.stride(-1) != 1:
        Bt = Bt.contiguous()
    if Ct.stride(-1) != 1:
        Ct = Ct.contiguous()
    strides = _checked(x, dt, Bt, Ct, A, h0, h_out)
    from repro_torch.kernels._build import launch
    lib = _library()
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
    ckpt = (torch.empty((B, n_checkpoints(T), Di, N), dtype=torch.float32,
                        device=x.device) if with_checkpoints else None)
    err = launch(x.get_device(), lib.ms_launch, x.data_ptr(), dt.data_ptr(),
                 Bt.data_ptr(), Ct.data_ptr(), p_a, p_h0 or None,
                 y.data_ptr(), p_h, None if ckpt is None else ckpt.data_ptr(),
                 B, T, Di, N, *strides)
    if err:
        raise RuntimeError(f"mamba1_scan launch failed: cudaError {err}")
    mamba1_scan.launches += 1
    return (y, h_last) if ckpt is None else (y, h_last, ckpt)


counted(mamba1_scan)


def _meta_backward(x, Bt, h0, dh_last):
    """``mamba1_scan_bwd`` on ``meta`` tensors: empty gradients, and the
    kernels' cost: 20 operations a (step, channel, state); x, dt, dy,
    B_t, C_t, A, the checkpoints, h0 and dh_last read and dx, ddt, dB, dC,
    dA and dh0 written once, all float32."""
    from repro_torch.kernels._build import on_meta
    B, T, Di = x.shape
    N = Bt.shape[-1]
    states = (n_checkpoints(T) + 1 + (h0 is not None)
              + (dh_last is not None))
    on_meta(20 * B * T * Di * N,
            4 * (5 * B * T * Di + 4 * B * T * N + 2 * Di * N
                 + states * B * Di * N))
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty((B, T, Di), **f32), torch.empty((B, T, Di), **f32),
            torch.empty((B, T, N), **f32), torch.empty((B, T, N), **f32),
            torch.empty((Di, N), **f32), torch.empty((B, Di, N), **f32))


def mamba1_scan_bwd(x, dt, Bt, Ct, A, h0, dy, dh_last, ckpt=None):
    """The backward pass of ``mamba1_scan``: its inputs (``h0`` may be
    None), ``dy`` [B, T, Di] and ``dh_last`` [B, Di, N] (None: zeros), all
    float32, and ``ckpt``, the checkpoints its forward pass wrote with
    ``with_checkpoints`` (None: on the card this call runs the forward
    kernel for them).  Returns (dx, ddt, dB, dC, dA, dh0) as
    ``mamba1_scan_bwd_reference`` does.

    CPU tensors take the plain version, which recomputes every state from
    ``h0`` and does not read ``ckpt``; CUDA tensors launch the kernels of
    ``csrc/mamba_scan_bwd.cu`` (the scan backward, then the fixed-order
    sums of its per-block partials) and add one to
    ``mamba1_scan_bwd.launches``; meta tensors give empty gradients and
    book the kernels' cost (``_meta_backward``)."""
    if x.device.type == "meta":
        return _meta_backward(x, Bt, h0, dh_last)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no kernel for device {x.device}")
        return mamba1_scan_bwd_reference(x, dt, Bt, Ct, A, h0, dy, dh_last)
    x, dt, Bt, Ct, A, dy = (t.contiguous() for t in (x, dt, Bt, Ct, A, dy))
    h0 = None if h0 is None else h0.contiguous()
    dh_last = None if dh_last is None else dh_last.contiguous()
    _check(x, dt, Bt, Ct, A, h0, dh_last)
    if dy.shape != x.shape or dy.dtype != torch.float32 \
            or dy.device != x.device:
        raise ValueError(f"want dy {tuple(x.shape)} float32 on {x.device}, "
                         f"got {tuple(dy.shape)} {dy.dtype} {dy.device}")
    B, T, Di = x.shape
    N = A.shape[1]
    if ckpt is None:
        ckpt = mamba1_scan(x, dt, Bt, Ct, A, h0, with_checkpoints=True)[2]
    elif (tuple(ckpt.shape) != (B, n_checkpoints(T), Di, N)
          or ckpt.dtype != torch.float32 or ckpt.device != x.device
          or not ckpt.is_contiguous()):
        raise ValueError(f"want ckpt [{B}, {n_checkpoints(T)}, {Di}, {N}] "
                         f"float32 contiguous on {x.device}, got "
                         f"{tuple(ckpt.shape)} {ckpt.dtype} {ckpt.device}")
    from repro_torch.kernels._build import launch
    lib = _library()
    f32 = dict(dtype=torch.float32, device=x.device)
    blocks = lib.msb_blocks(Di, N)                    # channel blocks
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    part_bc = torch.empty((blocks, B, T, 2 * N), **f32)
    part_a = torch.empty((B, Di, N), **f32)
    dh0 = torch.empty((B, Di, N), **f32)
    dbc = torch.empty((B, T, 2 * N), **f32)
    dA = torch.empty((Di, N), **f32)
    ptrs = [t.data_ptr() for t in (x, dt, Bt, Ct, A, dy, ckpt)]
    err = launch(x.get_device(), lib.msb_launch, *ptrs,
                 None if dh_last is None else dh_last.data_ptr(),
                 dx.data_ptr(), ddt.data_ptr(), part_bc.data_ptr(),
                 part_a.data_ptr(), dh0.data_ptr(), dbc.data_ptr(),
                 dA.data_ptr(), B, T, Di, N)
    if err:
        raise RuntimeError(f"mamba1_scan_bwd launch failed: cudaError {err}")
    mamba1_scan_bwd.launches += 1
    return dx, ddt, dbc[..., :N], dbc[..., N:], dA, dh0


counted(mamba1_scan_bwd)


class MambaScanFn(torch.autograd.Function):
    """B4 with a gradient: the forward pass is ``mamba1_scan`` (no
    ``h_out``) with checkpoints, the backward pass ``mamba1_scan_bwd`` from
    them, both by the tensors' device.  The inputs and the checkpoints are
    kept; each chunk's states are recomputed in the backward pass.  Returns
    (y, h_last); ``h0`` gets a gradient when it is given."""

    @staticmethod
    def forward(ctx, x, dt, Bt, Ct, A, h0):
        y, h_last, ckpt = mamba1_scan(x, dt, Bt, Ct, A, h0,
                                      with_checkpoints=True)
        ctx.save_for_backward(x, dt, Bt, Ct, A, h0, ckpt)
        # an output nobody used gets None, not a tensor of zeros: training
        # never reads h_last, and the kernel then skips its gradient
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, Bt, Ct, A, h0, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, dB, dC, dA, dh0 = mamba1_scan_bwd(x, dt, Bt, Ct, A, h0, dy,
                                                   dh_last, ckpt)
        return dx, ddt, dB, dC, dA, (None if h0 is None else dh0)
