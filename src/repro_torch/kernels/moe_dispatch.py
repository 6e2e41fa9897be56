"""The Mixture-of-Experts dispatch and combine at decode sizes, on Hopper.

The JAX package has no kernel here: routing, capacity buckets and the
combine (``src/repro/models/moe.py``) are left to XLA.  The port's plain
path (``models/moe.py``: ``_route``, ``_bucket``, ``_combine``) runs them as
some sixty small PyTorch kernels a layer, two of them sorts, which a
captured decode step pays for one launch at a time.  These two kernels
(``csrc/moe_dispatch.cu``, whose header says how they work and what bounds
them) do the same work in two launches around the experts' batched
products:

* ``moe_dispatch(logits, x, n_experts, top_k, capacity)``: from the
  router's float32 logits [N, E_pad] (the padded experts' columns masked
  here) and the tokens' rows x [N, d], the capacity buckets ``xe``
  [E_pad, C, d] in x's type, their gates ``ge`` [E_pad, C] float32, each
  token's k assignments in expert order ``slots`` [N, k] int32 (``e * C +
  slot``, or -1 where the bucket was full), and the switch aux loss.  Each
  assignment's slot is the number of earlier tokens that chose its expert,
  which is its position in ``_bucket``'s stable sort, so a full bucket
  drops the same assignments.
* ``moe_combine(y_e, ge, slots)``: each token's kept slots' rows scaled by
  their gates in the experts' type, summed over k in expert order in
  float32 and rounded once: [N, d].

Each wrapper checks its inputs once per call signature
(``_build.checked_once``), allocates its outputs with ``torch.empty``,
launches on the current stream, makes no host sync and raises if the
launch fails.  They take CUDA tensors only: the plain versions are
``models/moe.py``'s ``_route``, ``_bucket`` and ``_combine``, which the
card tests hold the kernels to.  ``takes`` says whether the kernels take a
call's sizes; ``models/moe.py`` asks it before it takes this path.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels._build import counted

MAX_EXPERTS = 64        # E_pad: a token's choice is one 64-bit mask
MAX_TOP_K = 8           # the combine keeps a token's slots in registers
# N * top_k, the kernel's resource limit: every dispatch block routes every
# token of the call itself, since no block can wait for another's routing,
# so the kernel's work grows as N^2 (the blocks grow with the capacity),
# and a gate and a rank per token sit in its shared memory.  2048 is 256
# tokens at top-8: decode steps take tens, prefills thousands.  Up to it
# the fused layer is the faster on an H100 (chip_smoke.py's phase 37, a
# replayed graph: granite-moe 2.0x the plain path at 256 tokens, 2.5x at
# 128; qwen2-moe-a2.7b 1.33x at 512), so no crossover sets it.
MAX_ASSIGNMENTS = 2048
DTYPES = (torch.float32, torch.bfloat16)


def takes(n_tokens: int, e_pad: int, top_k: int, d: int, dtype) -> bool:
    """Whether the kernels take a call of these sizes and this type."""
    return (dtype in DTYPES and 1 <= n_tokens
            and n_tokens * top_k <= MAX_ASSIGNMENTS
            and 1 <= top_k <= min(MAX_TOP_K, e_pad) and e_pad <= MAX_EXPERTS
            and d * torch.finfo(dtype).bits // 8 % 16 == 0)


@functools.cache
def _library():
    """The kernels' library, once its limits are known to be this
    module's, by which ``takes`` decides."""
    from repro_torch.kernels._build import load_library
    lib = load_library()
    have = tuple(lib.moe_limits(i) for i in range(3))
    want = (MAX_EXPERTS, MAX_TOP_K, MAX_ASSIGNMENTS)
    if have != want:
        raise RuntimeError(f"the moe kernels take (experts, top_k, "
                           f"assignments) up to {have}, the wrapper {want}")
    return lib


_CHECKED_DISPATCH: dict = {}
_CHECKED_COMBINE: dict = {}


def _check_dispatch(logits, x, n_experts: int, top_k: int,
                    capacity: int) -> bool:
    if logits.dim() != 2 or x.dim() != 2 or logits.shape[0] != x.shape[0]:
        raise ValueError(f"want logits [N, E_pad] and x [N, d]; got "
                         f"{tuple(logits.shape)}, {tuple(x.shape)}")
    (N, E), d = logits.shape, x.shape[1]
    if logits.dtype != torch.float32 or x.dtype not in DTYPES:
        raise TypeError(f"want float32 logits and x in {DTYPES}; got "
                        f"{logits.dtype}, {x.dtype}")
    if not takes(N, E, top_k, d, x.dtype) or not 1 <= n_experts <= E \
            or capacity < 1:
        raise ValueError(f"the kernel does not take N {N}, E_pad {E}, "
                         f"n_experts {n_experts}, top_k {top_k}, d {d} "
                         f"({x.dtype}), capacity {capacity}")
    if not (logits.is_contiguous() and x.is_contiguous()):
        raise ValueError("the kernel reads logits and x as contiguous rows")
    if logits.device != x.device:
        raise ValueError("logits and x lie on different devices")
    return True


def moe_dispatch(logits, x, n_experts: int, top_k: int, capacity: int,
                 renormalize: bool = True):
    """logits [N, E_pad] float32, x [N, d] bf16 or float32 -> (xe [E_pad,
    C, d], ge [E_pad, C] float32, slots [N, k] int32, aux float32 scalar).
    The gates are the top-k probabilities over their sum, or as they are
    without ``renormalize``.

    Launches the kernel and adds one to ``moe_dispatch.launches``."""
    if not logits.is_cuda:
        raise ValueError(f"no kernel for device {logits.device}")
    from repro_torch.kernels._build import checked_once, launch
    checked_once(_CHECKED_DISPATCH,
                 lambda: _check_dispatch(logits, x, n_experts, top_k,
                                         capacity),
                 logits, x, n_experts, top_k, capacity)
    lib = _library()
    (N, E), d = logits.shape, x.shape[1]
    xe = torch.empty((E, capacity, d), dtype=x.dtype, device=x.device)
    ge = torch.empty((E, capacity), dtype=torch.float32, device=x.device)
    slots = torch.empty((N, top_k), dtype=torch.int32, device=x.device)
    aux = torch.empty((), dtype=torch.float32, device=x.device)
    ptrs = [t.data_ptr() for t in (logits, x, xe, ge, slots, aux)]
    if any(p % 16 for p in ptrs[:3]):
        raise ValueError("the kernel moves rows as 16-byte vectors: logits, "
                         "x and xe must be 16-byte aligned")
    err = launch(x.get_device(), lib.moe_dispatch_launch, *ptrs, N, E,
                 n_experts, top_k, capacity, d * x.element_size(),
                 int(renormalize))
    if err:
        raise RuntimeError(f"moe_dispatch launch failed: cudaError {err}")
    moe_dispatch.launches += 1
    return xe, ge, slots, aux


counted(moe_dispatch)


def _check_combine(y_e, ge, slots) -> bool:
    if y_e.dim() != 3 or tuple(ge.shape) != tuple(y_e.shape[:2]) \
            or slots.dim() != 2:
        raise ValueError(f"want y_e [E_pad, C, d], ge [E_pad, C], slots "
                         f"[N, k]; got {tuple(y_e.shape)}, {tuple(ge.shape)}, "
                         f"{tuple(slots.shape)}")
    if y_e.dtype not in DTYPES or ge.dtype != torch.float32 \
            or slots.dtype != torch.int32:
        raise TypeError(f"want y_e in {DTYPES}, float32 ge and int32 slots; "
                        f"got {y_e.dtype}, {ge.dtype}, {slots.dtype}")
    if y_e.shape[2] * y_e.element_size() % 16 or slots.shape[0] < 1 \
            or slots.shape[1] < 1:
        raise ValueError(f"the kernel takes rows of a multiple of 16 bytes "
                         f"and at least one slot; got d {y_e.shape[2]} "
                         f"({y_e.dtype}), slots {tuple(slots.shape)}")
    if not (y_e.is_contiguous() and ge.is_contiguous()
            and slots.is_contiguous()):
        raise ValueError("the kernel reads y_e, ge and slots contiguous")
    if not y_e.device == ge.device == slots.device:
        raise ValueError("y_e, ge and slots lie on different devices")
    return True


def moe_combine(y_e, ge, slots):
    """y_e [E_pad, C, d] bf16 or float32, ge [E_pad, C] float32, slots
    [N, k] int32 (from ``moe_dispatch``) -> [N, d] in y_e's type.

    Launches the kernel and adds one to ``moe_combine.launches``."""
    if not y_e.is_cuda:
        raise ValueError(f"no kernel for device {y_e.device}")
    from repro_torch.kernels._build import checked_once, launch
    checked_once(_CHECKED_COMBINE, lambda: _check_combine(y_e, ge, slots),
                 y_e, ge, slots)
    lib = _library()
    N, k = slots.shape
    d = y_e.shape[2]
    out = torch.empty((N, d), dtype=y_e.dtype, device=y_e.device)
    if (y_e.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("the kernel moves rows as 16-byte vectors: y_e and "
                         "the output must be 16-byte aligned")
    err = launch(y_e.get_device(), lib.moe_combine_launch,
                 DTYPES.index(y_e.dtype), y_e.data_ptr(), ge.data_ptr(),
                 slots.data_ptr(), out.data_ptr(), N, k,
                 d * y_e.element_size())
    if err:
        raise RuntimeError(f"moe_combine launch failed: cudaError {err}")
    moe_combine.launches += 1
    return out


counted(moe_combine)
