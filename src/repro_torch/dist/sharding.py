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

The mesh half places tensors as ``torch.distributed`` DTensors.  A mesh
is then a ``DeviceMesh`` (``repro_torch.launch.mesh``) and a spec becomes
one DTensor ``Placement`` per mesh dimension (``placements``):
``Shard(i)`` on each mesh axis that entry ``i`` names (a tuple entry
shards dim ``i`` over several axes, in mesh order) and ``Replicate()``
elsewhere.  ``shard(x, *axes)`` keeps its identity short-cut and
otherwise redistributes a DTensor, or places a plain (global) tensor, by
the spec; ``place(x, spec)`` does the same for a resolved spec.  Placing a
plain tensor slices out this rank's shard and communicates nothing, so
every rank must hold the same global tensor (the tests build theirs from
one seed; the dry-run's are ``meta`` tensors).  ``shard_map(f, mesh,
in_specs, out_specs)`` is the reference's: ``f`` runs on each rank's
local shards (the explicit ``to_local`` / ``DTensor.from_local`` form of
``local_map``), where ``axis_index(name)`` is the rank's coordinate on a
mesh axis and ``psum``, ``pmean``, ``pmax`` and ``all_to_all`` are
collectives over named axes, built on
``torch.distributed._functional_collectives`` so that ``CommDebugMode``
sees them.  ``replicated_inputs()`` is the scope in which plain tensors
meet DTensors as replicated values (rotary angles, masks, positions): the
model's entry points run in it under a mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

# name of the physical tensor-parallel mesh axis; every other axis is data
TP_AXIS = "model"

LogicalAxis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


class _ThreadState(threading.local):
    def __init__(self):
        self.mesh_stack: list = []
        self.seq_sharding: bool = False
        self.replicated: bool = False


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


def placements(spec: Spec, mesh_names: Sequence[str]) -> tuple:
    """One DTensor placement per mesh dimension for ``spec``: ``Shard(i)``
    on each mesh axis that entry ``i`` names, ``Replicate()`` elsewhere.  A
    tuple entry names its axes in mesh order (the order in which DTensor
    nests the shards), and a spec names each axis once."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh_names)
    out = [Replicate()] * len(names)
    for i, e in enumerate(spec):
        axes = () if e is None else ((e,) if isinstance(e, str) else e)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {e!r} is not in mesh order {names}")
        for j in idx:
            if not isinstance(out[j], Replicate):
                raise ValueError(f"mesh axis {names[j]!r} named twice in "
                                 f"{spec}")
            out[j] = Shard(i)
    return tuple(out)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (placed on a mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def spec_of(x) -> Spec:
    """The spec of a DTensor's placements (the inverse of ``placements``);
    a plain tensor's is all ``None``.  A ``Partial`` placement is no
    layout and raises."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return (None,) * x.dim()
    entries = [()] * x.dim()
    for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        if isinstance(p, Shard):
            entries[p.dim] += (name,)
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} of mesh axis {name!r} is no "
                             f"layout")
    return tuple(None if not e else (e[0] if len(e) == 1 else e)
                 for e in entries)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (spec trees and tensor
    trees), with the same keys' leaves of ``rest``; a key that ``rest``
    lacks is an empty subtree (a norm with no weights)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r.get(k, {}) for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _entry_axes(e) -> Tuple[str, ...]:
    return () if e is None else ((e,) if isinstance(e, str) else tuple(e))


_COORDS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def coordinate(name: str, mesh=None) -> int:
    """This rank's coordinate on mesh axis ``name`` (cached per mesh: a
    ``DeviceMesh`` computes it anew on every call)."""
    mesh = mesh if mesh is not None else current().mesh
    coords = _COORDS.setdefault(mesh, {})
    if name not in coords:
        coords[name] = mesh.get_local_rank(name)
    return coords[name]


def shard_index(entry, mesh=None) -> int:
    """Which shard of a dimension this rank holds under one spec entry: its
    coordinates on the entry's axes, the first axis the outermost."""
    mesh = mesh if mesh is not None else current().mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    idx = 0
    for a in _entry_axes(entry):
        idx = idx * sizes[a] + coordinate(a, mesh)
    return idx


def _local_slice(x, spec: Spec, mesh):
    """This rank's shard of the global tensor ``x`` under ``spec``."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for dim, e in enumerate(spec):
        axes = _entry_axes(e)
        if not axes:
            continue
        n = math.prod(sizes[a] for a in axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axes} ({n})")
        step = x.shape[dim] // n
        x = x.narrow(dim, shard_index(e, mesh) * step, step)
    return x


def from_local(local, spec: Spec, mesh):
    """The DTensor of ``spec``'s placements whose shard on this rank is
    ``local`` (every rank's shard alike in shape; differentiable, no
    communication)."""
    from torch.distributed.tensor import DTensor
    spec = tuple(spec) + (None,) * (local.dim() - len(spec))
    return DTensor.from_local(local, mesh,
                              placements(spec, mesh.mesh_dim_names),
                              run_check=False)


def place(x, spec: Spec, mesh=None):
    """``x`` laid out by ``spec`` on ``mesh`` (the active one by default):
    a DTensor is redistributed (by the collectives DTensor picks); a plain
    tensor is taken as the global value, held alike by every rank, and
    this rank's shard of it is copied out (so that the shard does not
    keep the global tensor alive), with no communication."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    mesh = mesh if mesh is not None else current().mesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"placing a tensor (spec {tuple(spec)}) needs a "
                        f"torch.distributed DeviceMesh, not {mesh!r}")
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements(spec, mesh.mesh_dim_names))
    return from_local(_local_slice(x, spec, mesh).clone(), spec, mesh)


def shard(x, *axes: LogicalAxis):
    """Constrain ``x`` to the logical-axis layout under the active mesh.

    Identity (returns ``x`` itself) when no mesh is active or when every
    axis falls back to replicated, so single-device paths pay nothing;
    otherwise ``place(x, spec)``.  A DTensor that holds a pending sum
    (DTensor's ``Partial``, which XLA keeps out of sight) is always
    placed, so that the sum is taken here, where the reference constrains
    the layout, not where DTensor's next op would choose.  As the
    reference's constraint does, it constrains the gradient too: the
    gradient of the result is placed by the same spec before it flows
    back (otherwise DTensor may carry a pending sum back through the
    layer and gather the weights it meets to multiply by it)."""
    ctx = current()
    if not ctx.active:
        return x
    spec = spec_for(x.shape, *axes)
    if all(e is None for e in spec) and not _pending_sum(x):
        return x
    if is_dtensor(x) and x.requires_grad and torch.is_grad_enabled():
        return _Constrain.apply(x, spec, ctx.mesh)
    return place(x, spec, ctx.mesh)


class _Constrain(torch.autograd.Function):
    """``place`` in both directions: the value, and its gradient, which
    then goes back to the input's placements as DTensor's own
    redistribution sends it (a pending sum there taken as replicated)."""

    @staticmethod
    def forward(fctx, x, spec, mesh):
        fctx.spec, fctx.mesh, fctx.src = spec, mesh, x.placements
        return place(x, spec, mesh)

    @staticmethod
    def backward(fctx, g):
        from torch.distributed.tensor import Replicate
        src = tuple(Replicate() if p.is_partial() else p for p in fctx.src)
        g = place(g, fctx.spec, fctx.mesh)
        return g.redistribute(fctx.mesh, src), None, None


def _pending_sum(x) -> bool:
    return is_dtensor(x) and any(p.is_partial() for p in x.placements)


def shard_map(f: Callable, mesh, in_specs, out_specs):
    """``f`` over each rank's local shards: the reference's ``shard_map``.

    Each positional argument with a spec (a tuple; ``None`` passes the
    argument through untouched) is laid out by ``place`` and its local
    shard handed to ``f``; each output of ``f`` (a tensor, or a tuple of
    them with a tuple of out specs) becomes the DTensor of its out spec
    whose shard here is that output.  ``f`` sees local shapes and runs its
    own collectives (``psum``, ``all_to_all``, ...); an out spec of ``()``
    (the reference's ``P()``) declares a replicated value.

    Gradients flow through both ends, with the reference's transpose: the
    body is split over every mesh axis that an input's spec names, and an
    input replicated over such an axis gets the sum of every rank's share
    of its gradient there (an all-reduce in the backward pass), while over
    an axis that no input names every rank computed the same, and each
    rank's gradient is the whole."""
    split = {a for s in in_specs if s is not None for e in s
             for a in _entry_axes(e)}

    def local_of(a, spec):
        local = place(a, spec, mesh).to_local()
        named = {n for e in spec for n in _entry_axes(e)}
        summed = tuple(n for n in mesh.mesh_dim_names
                       if n in split and n not in named)
        if summed and local.requires_grad:
            local = _SumGrad.apply(local, summed)
        return local

    def run(*args):
        local = [a if s is None else local_of(a, s)
                 for a, s in zip(args, in_specs)]
        out = f(*local)
        if isinstance(out, tuple):
            return tuple(from_local(o, s, mesh)
                         for o, s in zip(out, out_specs))
        return from_local(out, out_specs, mesh)
    return run


def axis_index(name: str) -> int:
    """This rank's coordinate on mesh axis ``name`` (the reference's
    ``jax.lax.axis_index`` inside a ``shard_map`` body)."""
    return coordinate(name)


def _all_reduce(x, op: str, names: Tuple[str, ...]):
    from torch.distributed import _functional_collectives as funcol
    mesh = current().mesh
    for name in names:
        if mesh[name].size() > 1:
            x = funcol.wait_tensor(funcol.all_reduce(x, op, mesh[name]))
    return x


class _Sum(torch.autograd.Function):
    """All-reduce sum over mesh axes, times ``scale``, of a value every
    rank then uses alike: the gradient that reaches it is the replicated
    whole, which each addend takes as it is (times ``scale``)."""

    @staticmethod
    def forward(ctx, x, names, scale):
        ctx.scale = scale
        y = _all_reduce(x, "sum", names)
        return y if scale == 1.0 else y * scale

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.scale == 1.0 else g * ctx.scale), None, None


class _SumGrad(torch.autograd.Function):
    """The identity, whose backward pass sums the gradient over mesh
    axes (a ``shard_map`` input replicated over axes its body is split
    on)."""

    @staticmethod
    def forward(ctx, x, names):
        ctx.names = names
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, "sum", ctx.names), None


def psum(x, names):
    """Sum of ``x`` over the mesh axes ``names`` (``jax.lax.psum``)."""
    return _Sum.apply(x, _entry_axes(names), 1.0)


def pmean(x, names):
    """Mean of ``x`` over the mesh axes ``names`` (``jax.lax.pmean``)."""
    axes = _entry_axes(names)
    n = math.prod(current().axis_sizes[a] for a in axes)
    return _Sum.apply(x, axes, 1.0 / n)


def pmax(x, names):
    """Elementwise max over the mesh axes ``names`` (no gradient)."""
    return _all_reduce(x, "max", _entry_axes(names))


def all_to_all(x, name: str, split_axis: int, concat_axis: int):
    """``jax.lax.all_to_all(x, name, split_axis, concat_axis, tiled=True)``:
    ``x`` is cut into ``n`` blocks along ``split_axis``, block ``j`` goes to
    rank ``j`` of axis ``name``, and the blocks received are concatenated
    along ``concat_axis`` in rank order.  Differentiable (the gradient
    takes the inverse exchange)."""
    from torch.distributed import _functional_collectives as funcol
    mesh = current().mesh
    n = mesh[name].size()
    if n == 1:
        return x
    shape = list(x.shape)
    blk = shape[split_axis] // n
    # the blocks on a leading axis, one all_to_all_single over it
    y = x.unflatten(split_axis, (n, blk)).movedim(split_axis, 0).contiguous()
    y = funcol.wait_tensor(funcol.all_to_all_single_autograd(
        y.flatten(0, 1), None, None, mesh[name]))
    # y[i] is rank i's block: x's shape with split_axis cut to blk
    y = y.reshape(n, *shape[:split_axis], blk, *shape[split_axis + 1:])
    return y.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


@contextlib.contextmanager
def replicated_inputs():
    """Under an active mesh, the scope in which a plain tensor that meets
    a DTensor counts as a replicated value (DTensor's
    ``implicit_replication``); a no-op without one."""
    if not current().active or _STATE.replicated:
        yield                   # (DTensor's scope does not nest)
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _STATE.replicated = True
    try:
        with implicit_replication():
            yield
    finally:
        _STATE.replicated = False
