"""The published Mamba-2's chunked SSD over a prefill, on Hopper.

The JAX package has no kernel here: it runs zamba2's chunked SSD as
``jnp.einsum``s (``src/repro/models/ssm.py:232-246``), and the published
block (granite-4.0-h's) is port-only.  The port's plain version is
``models.ssm.ssd_reference``: torch products over float32 decay matrices
[B, heads, chunks, T, T] that it materialises in device memory.  This
kernel (``csrc/ssd_chunk.cu``, whose header says how it works and what
bounds it) does the same float32 work in four passes that keep the decays
on chip: the running sums of ``dt A`` in each chunk; ``C.B`` once per group
and chunk, only on and below the diagonal; each chunk's end state and the
carry between chunks, in chunk order; and each chunk's output, the decays
built in shared memory from the running sums.

``ssd_chunk(x, dt, A, Bg, Cg, chunk, h0)`` takes x [B, S, nh, 64] and Bg,
Cg [B, S, G, 128] in bf16 (the conv's output; slices of one tensor, as
the block's conv writes them, need only unit strides over their last two
dims and 16-byte aligned rows), dt [B, S, nh] and A [nh] float32, h0 [B,
nh, 64, 128] float32 or None, and returns (y [B, S, nh, 64] without the D
term, h_last [B, nh, 64, 128]), both float32, as ``ssd_reference`` does.
It checks its inputs once per call signature (``_build.checked_once``)
and their alignment on every call, allocates its outputs and scratch with
``torch.empty``, launches on the current stream, makes no host sync and
raises if a launch fails.  It takes CUDA tensors only, and raises on
sizes or a type that ``takes`` refuses.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels._build import counted

HEAD_DIM = 64           # a thread's 8 x 8 tiles of y and of the state
D_STATE = 128
MAX_CHUNK = 256         # the running sums: 8 positions a lane
CHUNK_STEP = 64         # the rows of an output tile
HEADS_STEP = 4          # heads of one group that share a C and C.B tile
DTYPE = torch.bfloat16   # of x, B and C


def takes(head_dim: int, d_state: int, n_heads: int, groups: int,
          chunk: int, dtype) -> bool:
    """Whether the kernel takes a call of these sizes and this type of x,
    B and C."""
    return (dtype == DTYPE and head_dim == HEAD_DIM and d_state == D_STATE
            and CHUNK_STEP <= chunk <= MAX_CHUNK and chunk % CHUNK_STEP == 0
            and groups >= 1 and n_heads % groups == 0
            and (n_heads // groups) % HEADS_STEP == 0)


@functools.cache
def _library():
    """The kernel's library, once its limits are known to be this
    module's, by which ``takes`` decides."""
    from repro_torch.kernels._build import load_library
    lib = load_library()
    have = tuple(lib.ssd_limits(i) for i in range(5))
    want = (HEAD_DIM, D_STATE, MAX_CHUNK, CHUNK_STEP, HEADS_STEP)
    if have != want:
        raise RuntimeError(f"the SSD kernel takes (head dim, d_state, chunk, "
                           f"chunk step, heads step) {have}, the wrapper "
                           f"{want}")
    return lib


_CHECKED: dict = {}


def _rows_ok(t) -> bool:
    """Unit strides over the last two dims, packed, and every row start a
    multiple of 16 bytes apart."""
    return (t.stride(-1) == 1 and t.stride(-2) == t.shape[-1]
            and all(s * t.element_size() % 16 == 0 for s in t.stride()[:2]))


def _check(x, dt, A, Bg, Cg, chunk: int, h0) -> bool:
    if x.dim() != 4 or Bg.dim() != 4 or Cg.shape != Bg.shape:
        raise ValueError(f"want x [B, S, nh, hd] and B, C [B, S, G, n]; got "
                         f"{tuple(x.shape)}, {tuple(Bg.shape)}, "
                         f"{tuple(Cg.shape)}")
    Bsz, S, nh, hd = x.shape
    G, n = Bg.shape[2:]
    if tuple(Bg.shape[:2]) != (Bsz, S) or tuple(dt.shape) != (Bsz, S, nh) \
            or tuple(A.shape) != (nh,):
        raise ValueError(f"want dt [B, S, nh] and A [nh] beside x "
                         f"{tuple(x.shape)}; got {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, B {tuple(Bg.shape)}")
    if h0 is not None and tuple(h0.shape) != (Bsz, nh, hd, n):
        raise ValueError(f"want h0 [B, nh, hd, n] = {(Bsz, nh, hd, n)}; got "
                         f"{tuple(h0.shape)}")
    if not (x.dtype == Bg.dtype == Cg.dtype == DTYPE) \
            or dt.dtype != torch.float32 \
            or A.dtype != torch.float32 \
            or (h0 is not None and h0.dtype != torch.float32):
        raise TypeError(f"want x, B and C bf16, dt, A and h0 float32; "
                        f"got {x.dtype}, {Bg.dtype}, {Cg.dtype}, {dt.dtype}, "
                        f"{A.dtype}, {None if h0 is None else h0.dtype}")
    if not takes(hd, n, nh, G, chunk, x.dtype):
        raise ValueError(f"the kernel does not take head dim {hd}, d_state "
                         f"{n}, {nh} heads in {G} groups, chunk {chunk}, "
                         f"{x.dtype}")
    nc = -(-S // chunk)
    if nc * Bsz > 65535 or Bsz * G > 65535:
        raise ValueError(f"{Bsz} sequences of {nc} chunks: past the grid")
    if not (_rows_ok(x) and _rows_ok(Bg) and _rows_ok(Cg)):
        raise ValueError("the kernel reads x, B and C as packed 16-byte "
                         "aligned rows (unit strides over the last two dims)")
    if not (dt.is_contiguous() and A.is_contiguous()
            and (h0 is None or h0.is_contiguous())):
        raise ValueError("the kernel reads dt, A and h0 contiguous")
    devices = {t.device for t in (x, dt, A, Bg, Cg, h0) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"the inputs lie on several devices: {devices}")
    return True


def ssd_chunk(x, dt, A, Bg, Cg, chunk: int, h0=None):
    """The chunked SSD (module docstring) -> (y [B, S, nh, hd], h_last
    [B, nh, hd, n]), float32.

    Launches the kernel's four passes and adds one to
    ``ssd_chunk.launches``."""
    if not x.is_cuda:
        raise ValueError(f"no kernel for device {x.device}")
    from repro_torch.kernels._build import checked_once, launch
    checked_once(_CHECKED, lambda: _check(x, dt, A, Bg, Cg, chunk, h0),
                 x, dt, A, Bg, Cg, chunk, h0)
    lib = _library()
    Bsz, S, nh, hd = x.shape
    G, n = Bg.shape[2:]
    nc = -(-S // chunk)
    f32, dev = torch.float32, x.device
    y = torch.empty((Bsz, S, nh, hd), dtype=f32, device=dev)
    h_last = torch.empty((Bsz, nh, hd, n), dtype=f32, device=dev)
    cum = torch.empty((3, Bsz, nh, nc * chunk), dtype=f32, device=dev)
    cb = torch.empty((Bsz, G, nc, chunk, chunk), dtype=f32, device=dev)
    hT = torch.empty((Bsz, nh, nc, n, hd), dtype=f32, device=dev)
    ins = (x, Bg, Cg) + (() if h0 is None else (h0,))
    if any(t.data_ptr() % 16 for t in ins):
        raise ValueError("the kernel reads x, B, C and h0 as 16-byte vectors: "
                         "they must be 16-byte aligned")
    err = launch(x.get_device(), lib.ssd_launch, x.data_ptr(),
                 dt.data_ptr(), A.data_ptr(), Bg.data_ptr(), Cg.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(), cum.data_ptr(), cb.data_ptr(),
                 hT.data_ptr(), Bsz, S, nh, G, chunk, x.stride(0),
                 x.stride(1), Bg.stride(0), Bg.stride(1), Cg.stride(0),
                 Cg.stride(1))
    if err:
        raise RuntimeError(f"ssd_chunk launch failed: cudaError {err}")
    ssd_chunk.launches += 1
    return y, h_last


counted(ssd_chunk)
