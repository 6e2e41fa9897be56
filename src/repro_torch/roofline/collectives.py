"""Collective bytes of a traced step: the twin of ``src/repro/roofline/
hlo.py``.

torch has no HLO to parse.  The dry-run traces one rank's step under
``CollectiveCounter``, a ``torch.distributed.tensor.debug.CommDebugMode``
that also adds up each collective's operand bytes as it is dispatched:
the collectives DTensor issues when it redistributes (all-gather,
all-reduce, reduce-scatter) and those the ``shard_map`` bodies run
themselves (``psum``, ``all_to_all``), all through
``torch.distributed._functional_collectives``.  ``collective_bytes``
turns the counts and bytes into the reference's record: ``<op>_bytes`` and
``<op>_count`` per op type (the reference's op names: ``all-gather``,
``all-reduce``, ``reduce-scatter``, ``all-to-all``), ``total_bytes`` and
``total_count``, all per device.

``hlo.py`` also halves the bytes of collectives that XLA:CPU promoted from
bf16 to float32 (its ``total_bytes_tpu``); that adjustment is specific to
XLA:CPU and has no twin: a traced collective moves its operand's own
dtype, so ``total_bytes_h100`` is ``total_bytes``.
"""
from __future__ import annotations

import collections
from typing import Dict

import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode

# funcol / c10d op names -> the reference's HLO opcode names
_NAMES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
          ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("alltoall", "all-to-all"))


def op_name(packet) -> str:
    """The reference's name of a collective op (its own name otherwise)."""
    name = str(getattr(packet, "__name__", packet)).lower()
    for key, out in _NAMES:
        if key in name:
            return out
    return name


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(t) for t in x)
    return 0


def _collective_ops(mode: CommDebugMode) -> set:
    ops = set(getattr(mode, "comm_registry", ()))
    try:
        from torch.distributed.tensor.debug._comm_mode import (
            c10d_collective_ops,
        )
        ops |= set(c10d_collective_ops)
    except ImportError:
        pass
    return ops


class CollectiveCounter(CommDebugMode):
    """``CommDebugMode``'s collective registry and counts
    (``get_comm_counts()``), plus each collective's operand bytes per op
    type in ``operand_bytes`` and its count in ``op_counts``, under the
    reference's names.

    It does not enter ``CommDebugMode``'s per-module tracker, whose module
    hooks fail on a module that one step calls more than once (zamba2's
    shared block, a module over microbatches): the counts are per step,
    not per module."""

    def __init__(self):
        super().__init__()
        self.operand_bytes: Dict[str, int] = collections.defaultdict(int)
        self.op_counts: Dict[str, int] = collections.defaultdict(int)
        self._ops = _collective_ops(self)

    def __enter__(self):
        self.comm_counts.clear()
        TorchDispatchMode.__enter__(self)
        return self

    def __exit__(self, *args):
        TorchDispatchMode.__exit__(self, *args)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor first, then its collectives
        out = func(*args, **(kwargs or {}))
        packet = getattr(func, "_overloadpacket", None)
        if packet in self._ops:
            self.comm_counts[packet] += 1
            name = op_name(packet)
            self.operand_bytes[name] += _nbytes(args[0]) if args else 0
            self.op_counts[name] += 1
        return out


def collective_bytes(counter: CollectiveCounter) -> Dict[str, int]:
    """Per-op operand-byte totals and counts, and their sums (per device),
    with the reference's keys (``total_bytes_tpu`` as
    ``total_bytes_h100``, the same as ``total_bytes``)."""
    out = {f"{k}_bytes": int(v) for k, v in sorted(
        counter.operand_bytes.items())}
    out.update({f"{k}_count": int(v) for k, v in sorted(
        counter.op_counts.items())})
    out["total_bytes"] = int(sum(counter.operand_bytes.values()))
    out["total_bytes_h100"] = out["total_bytes"]
    out["total_count"] = int(sum(counter.op_counts.values()))
    return out
