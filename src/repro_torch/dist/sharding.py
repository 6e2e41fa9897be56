"""Logical-axis sharding context: the port of ``src/repro/dist/sharding.py``.

Mesh-aware code programs against three *logical* axes:

  * ``"dp"`` — data parallelism; resolves to every physical mesh axis that
    is not the tensor axis;
  * ``"tp"`` — tensor parallelism; resolves to ``("model",)``;
  * ``"sp"`` — sequence parallelism; resolves to ``("model",)`` only while
    a ``sequence_sharding(True)`` scope is active, ``None`` otherwise.

A mesh is described by the ``mesh_dim_names`` and ``shape`` of a
``torch.distributed.device_mesh.DeviceMesh`` (any object with those two
attributes will do, which is how the CPU tests describe one).  The active
mesh lives in a thread-local stack managed by ``use_mesh``; ``current()``
returns a ``MeshContext`` whose ``tp``/``dp`` are always ``>= 1``.  With no
mesh active every operation is the single-device identity: ``shard(x,
...)`` returns ``x`` itself.  A spec here is a tuple with one entry per
dimension: ``None`` (replicated), a mesh-axis name, or a tuple of names.

``spec_for(shape, *axes)`` keeps the reference's divisibility fallback: a
logical axis is dropped from the spec when the resolved mesh-axis product
does not divide the dimension, and size-1 mesh axes are dropped outright.

This is the layer's logical half.  Placing a tensor on a mesh (DTensor
placements, the moe layers' ``shard_map`` bodies, the param and cache
shardings) is ROADMAP.md's sharding item, Queue 1: ``shard`` raises
``NotImplementedError`` for a spec that would place a tensor, rather than
silently doing nothing, and ``shard_map`` is not ported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

# name of the physical tensor-parallel mesh axis; every other axis is data
TP_AXIS = "model"

LogicalAxis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


class _ThreadState(threading.local):
    def __init__(self):
        self.mesh_stack: list = []
        self.seq_sharding: bool = False


_STATE = _ThreadState()


def pad_to_multiple(n: int, m: int) -> int:
    """Round ``n`` up to the next multiple of ``m`` (``m < 1`` -> ``n``)."""
    if m <= 1:
        return n
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class MeshContext:
    """Resolved view of the active mesh (or the inactive singleton).

    ``tp``/``dp`` are ``>= 1``; ``dp_axes``/``tp_axes`` are the physical
    axis-name tuples the logical axes resolve to (empty when inactive or
    when the mesh lacks the axis); ``axis_sizes`` maps each mesh axis to
    its size."""
    active: bool
    mesh: Optional[Any]
    tp: int
    dp: int
    dp_axes: Tuple[str, ...] = ()
    tp_axes: Tuple[str, ...] = ()
    axis_sizes: Dict[str, int] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_mesh(cls, mesh) -> "MeshContext":
        names = tuple(mesh.mesh_dim_names)
        sizes = dict(zip(names, (int(n) for n in mesh.shape)))
        tp_axes = tuple(n for n in names if n == TP_AXIS)
        dp_axes = tuple(n for n in names if n != TP_AXIS)
        tp = max(int(math.prod(sizes[n] for n in tp_axes)), 1)
        dp = max(int(math.prod(sizes.values())) // tp, 1)
        return cls(active=True, mesh=mesh, tp=tp, dp=dp, dp_axes=dp_axes,
                   tp_axes=tp_axes, axis_sizes=sizes)

    def resolve(self, axis: LogicalAxis) -> Optional[Tuple[str, ...]]:
        """Logical axis -> physical mesh-axis tuple (``None`` = replicated)."""
        if axis is None or not self.active:
            return None
        if isinstance(axis, tuple):
            out: Tuple[str, ...] = ()
            for a in axis:
                r = self.resolve(a)
                if r:
                    out += r
            return out or None
        if axis == "dp":
            return self.dp_axes or None
        if axis == "tp":
            return self.tp_axes or None
        if axis == "sp":
            return (self.tp_axes or None) if _STATE.seq_sharding else None
        if axis in self.axis_sizes:
            return (axis,)
        raise ValueError(f"unknown logical axis {axis!r} "
                         f"(mesh axes: {tuple(self.axis_sizes)})")

    def pspec(self, *logical_axes: LogicalAxis) -> Spec:
        """Direct resolution (no shape, no divisibility fallback)."""
        entries = []
        for ax in logical_axes:
            r = self.resolve(ax)
            if not r:
                entries.append(None)
            elif len(r) == 1:
                entries.append(r[0])
            else:
                entries.append(r)
        return tuple(entries)


_INACTIVE = MeshContext(active=False, mesh=None, tp=1, dp=1)


def current() -> MeshContext:
    """The innermost active MeshContext (thread-local), or the no-op one."""
    if _STATE.mesh_stack:
        return _STATE.mesh_stack[-1]
    return _INACTIVE


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for the current thread; yields the MeshContext."""
    ctx = MeshContext.from_mesh(mesh)
    _STATE.mesh_stack.append(ctx)
    try:
        yield ctx
    finally:
        _STATE.mesh_stack.pop()


@contextlib.contextmanager
def sequence_sharding(enabled: bool = True):
    """Scope in which the ``"sp"`` logical axis resolves to the tensor axis."""
    prev = _STATE.seq_sharding
    _STATE.seq_sharding = enabled
    try:
        yield
    finally:
        _STATE.seq_sharding = prev


def spec_for(shape: Sequence[int], *axes: LogicalAxis) -> Spec:
    """The spec for ``shape`` with the divisibility fallback.

    Per dimension: resolve the logical axis, drop size-1 mesh axes, and
    drop the whole entry when the remaining axis-size product does not
    divide the dimension (or the mesh axis was already used by an earlier
    dimension — a spec may name each mesh axis once)."""
    ctx = current()
    ndim = len(shape)
    if len(axes) > ndim:
        raise ValueError(f"{len(axes)} axes for a shape of rank {ndim}: "
                         f"{tuple(shape)}, {axes}")
    padded = tuple(axes) + (None,) * (ndim - len(axes))
    if not ctx.active:
        return (None,) * ndim
    sizes = ctx.axis_sizes
    used: set = set()
    entries = []
    for dim, ax in zip(shape, padded):
        r = ctx.resolve(ax)
        names = tuple(n for n in (r or ()) if sizes[n] > 1 and n not in used)
        if not names or dim % math.prod(sizes[n] for n in names) != 0:
            entries.append(None)
            continue
        used.update(names)
        entries.append(names[0] if len(names) == 1 else names)
    return tuple(entries)


def shard(x, *axes: LogicalAxis):
    """Constrain ``x`` to the logical-axis layout under the active mesh.

    Identity (returns ``x`` itself) when no mesh is active or when every
    axis falls back to replicated, so single-device paths pay nothing.  A
    spec that would place ``x`` on the mesh raises: placements are
    ROADMAP.md's sharding item (Queue 1), not yet ported."""
    ctx = current()
    if not ctx.active:
        return x
    spec = spec_for(x.shape, *axes)
    if all(e is None for e in spec):
        return x
    raise NotImplementedError(
        f"placing a tensor on the mesh (spec {spec}) is not ported yet: "
        f"ROADMAP.md, Queue 1, the sharding item (DTensor placements)")
