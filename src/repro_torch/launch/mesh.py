"""Production mesh builder: the port of ``src/repro/launch/mesh.py``.

Every mesh goes through ``make_debug_mesh`` so that the axis-name
conventions (``"model"`` is the tensor axis, every other axis data; see
``repro_torch.dist.sharding.TP_AXIS``) stay in one place.  A mesh is a
``torch.distributed`` ``DeviceMesh`` with ``mesh_dim_names`` over an
already-initialised default process group: gloo or nccl for real ranks
(each process gives ``init_process_group`` its address, world size and
rank), or ``fake_world`` for the dry-run, one process that stands for
every rank of the mesh.  A mesh may cover the first ranks of a larger
world, which is how one fake world of 512 holds both production meshes.

Functions, never module-level constants: importing this module touches
no process group.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist


def make_debug_mesh(shape=(1, 1), axes=("data", "model"), *,
                    device_type=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks
    ``0 .. prod(shape) - 1`` of the default process group, which must be
    initialised and at least that large.  ``device_type`` defaults to
    ``"cuda"`` under nccl and ``"cpu"`` otherwise."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_debug_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group, or "
                           "repro_torch.launch.mesh.fake_world)")
    n = math.prod(shape)
    if n > dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks, the world has "
                         f"{dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 256 ranks (16, 16) -> ("data", "model").
    Multi-pod: 2 pods x 256 ranks (2, 16, 16) -> ("pod", "data", "model")."""
    if multi_pod:
        return make_debug_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_debug_mesh((16, 16), ("data", "model"))


@contextlib.contextmanager
def fake_world(world_size: int = 512):
    """One process standing for ``world_size`` ranks (it is rank 0): torch's
    fake backend, whose collectives return at once and move nothing, for
    tracing a step on ``meta`` tensors.  A default process group that is
    already initialised is used as it is (and left alone)."""
    if dist.is_initialized():
        yield
        return
    # the import registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
