"""The Mixture-of-Experts routing, capacity buckets and combine at prefill
sizes, on Hopper: route once, then fill.

``kernels/moe_dispatch.py`` takes decode-sized calls: every block of its
dispatch routes every token, which bounds it to ``MAX_ASSIGNMENTS`` 2,048,
64 experts and top-8.  Past those the port's plain path
(``models/moe.py``: ``_route``, ``_bucket``, ``_combine``) sorts, gathers
and copies the buckets several times over, some 45 GB a layer at
granite-4.0-h's 65,536-token prefill.  These kernels (``csrc/
moe_routed.cu``, whose header says how they work and what bounds them)
route each token once across the grid, count each expert's choices per
block of tokens, scan the counts in block order and then fill, so they
move each row about once at any number of tokens, up to 128 experts and
top-16, around the same experts' batched products:

* ``moe_routed_dispatch(logits, x, n_experts, top_k, capacity)``: from
  the router's float32 logits [N, E_pad] (the padded experts' columns
  masked here) and the tokens' rows x [N, d], the capacity buckets ``xe``
  [E_pad, C, d] in x's type, their gates ``ge`` [E_pad, C] float32, each
  token's k assignments in expert order ``slots`` [N, k] int32 (``e * C +
  slot``, or -1 where the bucket was full), and the switch aux loss.  Each
  assignment's slot is the number of earlier tokens that chose its
  expert, which is its position in ``_bucket``'s stable sort, so a full
  bucket drops the same assignments.  Three kernels: route, offsets, fill.
* ``moe_routed_combine(y_e, ge, slots)``: each token's kept slots' rows
  scaled by their gates in the experts' type, summed over k in expert
  order in float32 and rounded once: [N, d].

Each wrapper checks its inputs once per call signature
(``_build.checked_once``), allocates its outputs and scratch with
``torch.empty``, launches on the current stream, makes no host sync and
raises if a launch fails; ``launches`` counts the kernels launched.  They
take CUDA tensors only: the plain versions are ``models/moe.py``'s
``_route``, ``_bucket`` and ``_combine``, which the card tests hold the
kernels to.  ``takes`` says whether the kernels take a call's sizes;
``models/moe.py`` asks it for a call that ``moe_dispatch.takes`` refuses.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels._build import counted

MAX_EXPERTS = 128       # E_pad: four experts a lane of the routing warp
MAX_TOP_K = 16          # the combine keeps a token's slots in registers
MAX_SLOTS = 2 ** 31 - 1  # E_pad * C and N * top_k: int32 slot indices
DTYPES = (torch.float32, torch.bfloat16)


def takes(n_tokens: int, e_pad: int, top_k: int, d: int, dtype,
          capacity: int) -> bool:
    """Whether the kernels take a call of these sizes and this type."""
    return (dtype in DTYPES and 1 <= n_tokens and 1 <= capacity
            and 1 <= top_k <= min(MAX_TOP_K, e_pad) and e_pad <= MAX_EXPERTS
            and e_pad * capacity <= MAX_SLOTS
            and n_tokens * top_k <= MAX_SLOTS
            and d * torch.finfo(dtype).bits // 8 % 16 == 0)


@functools.cache
def _library():
    """The kernels' library, once its limits are known to be this
    module's, by which ``takes`` decides."""
    from repro_torch.kernels._build import load_library
    lib = load_library()
    have = tuple(lib.moe_routed_limits(i) for i in range(2))
    want = (MAX_EXPERTS, MAX_TOP_K)
    if have != want:
        raise RuntimeError(f"the routed moe kernels take (experts, top_k) up "
                           f"to {have}, the wrapper {want}")
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
    if not takes(N, E, top_k, d, x.dtype, capacity) \
            or not 1 <= n_experts <= E:
        raise ValueError(f"the kernels do not take N {N}, E_pad {E}, "
                         f"n_experts {n_experts}, top_k {top_k}, d {d} "
                         f"({x.dtype}), capacity {capacity}")
    if not (logits.is_contiguous() and x.is_contiguous()):
        raise ValueError("the kernels read logits and x as contiguous rows")
    if logits.device != x.device:
        raise ValueError("logits and x lie on different devices")
    return True


def moe_routed_dispatch(logits, x, n_experts: int, top_k: int, capacity: int,
                        renormalize: bool = True):
    """logits [N, E_pad] float32, x [N, d] bf16 or float32 -> (xe [E_pad,
    C, d], ge [E_pad, C] float32, slots [N, k] int32, aux float32 scalar).
    The gates are the top-k probabilities over their sum, or as they are
    without ``renormalize``.

    Launches the route, offsets and fill kernels and adds three to
    ``moe_routed_dispatch.launches``."""
    if not logits.is_cuda:
        raise ValueError(f"no kernel for device {logits.device}")
    from repro_torch.kernels._build import checked_once, launch
    checked_once(_CHECKED_DISPATCH,
                 lambda: _check_dispatch(logits, x, n_experts, top_k,
                                         capacity),
                 logits, x, n_experts, top_k, capacity)
    lib = _library()
    (N, E), d = logits.shape, x.shape[1]
    dev = x.device
    xe = torch.empty((E, capacity, d), dtype=x.dtype, device=dev)
    ge = torch.empty((E, capacity), dtype=torch.float32, device=dev)
    slots = torch.empty((N, top_k), dtype=torch.int32, device=dev)
    aux = torch.empty((), dtype=torch.float32, device=dev)
    work = torch.empty(lib.moe_routed_workspace_bytes(N, E, top_k) // 4,
                       dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (logits, x, xe, ge, slots, aux, work)]
    if any(p % 16 for p in ptrs[:3]):
        raise ValueError("the kernels move rows as 16-byte vectors: logits, "
                         "x and xe must be 16-byte aligned")
    err = launch(x.get_device(), lib.moe_routed_dispatch_launch, *ptrs, N, E,
                 n_experts, top_k, capacity, d * x.element_size(),
                 int(renormalize))
    if err:
        raise RuntimeError(f"moe_routed_dispatch launch failed: cudaError "
                           f"{err}")
    moe_routed_dispatch.launches += 3
    return xe, ge, slots, aux


counted(moe_routed_dispatch)


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
            or not 1 <= slots.shape[1] <= MAX_TOP_K:
        raise ValueError(f"the kernel takes rows of a multiple of 16 bytes "
                         f"and 1 to {MAX_TOP_K} slots a token; got d "
                         f"{y_e.shape[2]} ({y_e.dtype}), slots "
                         f"{tuple(slots.shape)}")
    if not (y_e.is_contiguous() and ge.is_contiguous()
            and slots.is_contiguous()):
        raise ValueError("the kernel reads y_e, ge and slots contiguous")
    if not y_e.device == ge.device == slots.device:
        raise ValueError("y_e, ge and slots lie on different devices")
    return True


def moe_routed_combine(y_e, ge, slots):
    """y_e [E_pad, C, d] bf16 or float32, ge [E_pad, C] float32, slots
    [N, k] int32 (from ``moe_routed_dispatch``) -> [N, d] in y_e's type.

    Launches the kernel and adds one to ``moe_routed_combine.launches``."""
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
    err = launch(y_e.get_device(), lib.moe_routed_combine_launch,
                 DTYPES.index(y_e.dtype), y_e.data_ptr(), ge.data_ptr(),
                 slots.data_ptr(), out.data_ptr(), N, k,
                 d * y_e.element_size())
    if err:
        raise RuntimeError(f"moe_routed_combine launch failed: cudaError "
                           f"{err}")
    moe_routed_combine.launches += 1
    return out


counted(moe_routed_combine)
