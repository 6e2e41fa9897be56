"""The mesh half of ``repro_torch.dist.sharding`` and the spec trees.

* ``placements`` / ``spec_of`` as pure functions, and ``shard`` with a
  mesh that only describes itself (no process group): the identity where
  every axis falls back, a refusal where it would place.
* On a (2, 2) and a (2, 2, 1) gloo mesh of 4 CPU processes: ``place`` and
  ``shard`` give every rank its shard of the global tensor (a tuple entry
  nesting the data axes in mesh order), ``shard_map`` runs on the shards
  with ``axis_index``, ``psum``, ``pmean`` and ``pmax``, ``all_to_all``
  moves the blocks as ``jax.lax.all_to_all(..., tiled=True)`` does,
  ``write_slot`` writes a slot-sharded cache on the rank that holds the
  slot, and gradients through ``shard_map`` (partial over the axes its
  inputs are split on) equal plain autograd's.
* The param, cache, ZeRO-1 and batch spec trees of all ten architectures
  at their published widths on ``pod_16x16`` and ``multipod_2x16x16``
  equal the reference's ``PartitionSpec``s leaf by leaf: the reference
  builds its trees in a subprocess on 512 host devices (an Auto-axes
  mesh; nothing is compiled), the port from meta models under a mesh
  description.

Run as a script, this file is those subprocesses: ``python
tests/test_torch_sharding.py reference OUT`` or ``gloo OUT``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
ARCHS = ("whisper-small", "falcon-mamba-7b", "granite-20b", "gemma3-12b",
         "olmo-1b", "qwen2-0.5b", "zamba2-1.2b", "granite-moe-3b-a800m",
         "qwen2-moe-a2.7b", "qwen2-vl-7b")
PROD = {"pod_16x16": ((16, 16), ("data", "model")),
        "multipod_2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CELL_CACHE = ("decode_32k", "long_500k")
TIMEOUT = 240


def _as_list(spec):
    """A spec (tuple or PartitionSpec) as JSON: entries None, a name, or a
    list of names."""
    return [None if e is None else (e if isinstance(e, str) else list(e))
            for e in spec]


def _specs_json(tree, get):
    if isinstance(tree, dict):
        return {k: _specs_json(v, get) for k, v in tree.items()}
    return None if tree is None else _as_list(get(tree))


# ---------------------------------------------------------------------------
# the reference's trees (a subprocess on 512 host devices)
# ---------------------------------------------------------------------------


def run_reference(out: Path) -> None:
    import jax
    from jax.sharding import AxisType

    from repro.configs import CELLS_BY_NAME, cell_applicable, get_config
    from repro.configs import input_specs
    from repro.dist.sharding import use_mesh
    from repro.launch.dryrun import _batch_shardings
    from repro.models import model as JM
    from repro.train import optim as JO

    res = {}
    for mesh_name, (shape, axes) in PROD.items():
        mesh = jax.make_mesh(shape, axes,
                             axis_types=(AxisType.Auto,) * len(axes))
        with use_mesh(mesh):
            for arch in ARCHS:
                cfg = get_config(arch)
                pshape = jax.eval_shape(lambda k: JM.init_params(k, cfg),
                                        jax.random.PRNGKey(0))
                p_sh = JM.param_shardings(cfg, pshape)
                rec = {"param": _specs_json(p_sh, lambda s: s.spec),
                       "zero1": _specs_json(JO.zero1_shardings(p_sh, pshape),
                                            lambda s: s.spec)}
                for cell in CELL_CACHE:
                    c = CELLS_BY_NAME[cell]
                    if cell_applicable(cfg, c)[0]:
                        rec[f"cache|{cell}"] = _specs_json(
                            JM.cache_shardings(cfg, JM.cache_specs(
                                cfg, c.global_batch, c.seq_len)),
                            lambda s: s.spec)
                for cell, c in CELLS_BY_NAME.items():
                    specs = input_specs(cfg, c)
                    rec[f"batch|{cell}"] = _specs_json(
                        _batch_shardings(cfg, c, specs), lambda s: s.spec)
                res[f"{mesh_name}|{arch}"] = rec
    out.write_text(json.dumps(res))


@dataclasses.dataclass
class _Mesh:
    """What the port reads of a mesh to build specs."""
    mesh_dim_names: tuple
    shape: tuple


def port_trees(mesh_name: str, arch: str) -> dict:
    from repro_torch.configs import CELLS_BY_NAME, cell_applicable, get_config
    from repro_torch.configs import input_specs
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.dryrun import _batch_shardings
    from repro_torch.models import model as TM
    from repro_torch.train import optim as TO

    shape, axes = PROD[mesh_name]
    with use_mesh(_Mesh(axes, shape)):
        cfg = get_config(arch)
        shapes = TM.param_shapes(cfg)
        p_sh = TM.param_shardings(cfg, shapes)
        rec = {"param": _specs_json(p_sh, lambda s: s),
               "zero1": _specs_json(TO.zero1_shardings(p_sh, shapes),
                                    lambda s: s)}
        for cell in CELL_CACHE:
            c = CELLS_BY_NAME[cell]
            if cell_applicable(cfg, c)[0]:
                rec[f"cache|{cell}"] = _specs_json(TM.cache_shardings(
                    cfg, TM.cache_specs(cfg, c.global_batch, c.seq_len)),
                    lambda s: s)
        for cell, c in CELLS_BY_NAME.items():
            rec[f"batch|{cell}"] = _specs_json(
                _batch_shardings(cfg, c, input_specs(cfg, c)), lambda s: s)
    return rec


@pytest.fixture(scope="module")
def reference_trees(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "reference.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    proc = subprocess.run([sys.executable, str(Path(__file__)), "reference",
                           str(out)], env=env, capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("mesh_name", PROD)
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_the_reference(reference_trees, mesh_name, arch):
    want = reference_trees[f"{mesh_name}|{arch}"]
    got = port_trees(mesh_name, arch)
    assert sorted(got) == sorted(want)
    for kind in want:
        g, w = dict(_leaves(got[kind])), dict(_leaves(want[kind]))
        assert sorted(g) == sorted(w), kind
        for name in w:
            assert g[name] == w[name], (kind, name, g[name], w[name])
    # the ZeRO-1 tree shards something on every axis of the mesh
    used = {a for _, s in _leaves(got["zero1"]) if s for e in s if e
            for a in ([e] if isinstance(e, str) else e)}
    assert used == set(PROD[mesh_name][1])


# ---------------------------------------------------------------------------
# pure functions
# ---------------------------------------------------------------------------


def test_placements_and_spec_of_are_inverse():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.dist.sharding import placements
    names = ("pod", "data", "model")
    assert placements((("pod", "data"), None, "model"), names) == (
        Shard(0), Shard(0), Shard(2))
    assert placements((None, None), names) == (Replicate(),) * 3
    assert placements(("model", "data"), names) == (
        Replicate(), Shard(1), Shard(0))
    with pytest.raises(ValueError, match="mesh order"):
        placements((("data", "pod"),), names)
    with pytest.raises(ValueError, match="named twice"):
        placements(("model", "model"), names)


def test_shard_without_a_device_mesh():
    import torch

    from repro_torch.dist import sharding as TS
    x = torch.ones(4, 6)
    assert TS.shard(x, "dp", "tp") is x                 # no mesh
    with TS.use_mesh(_Mesh(("data", "model"), (1, 1))):
        assert TS.shard(x, "dp", "tp") is x             # every axis size 1
    with TS.use_mesh(_Mesh(("data", "model"), (3, 5))):
        assert TS.shard(x, "dp", "tp") is x             # neither divides
    with TS.use_mesh(_Mesh(("data", "model"), (2, 3))):
        with pytest.raises(TypeError, match="DeviceMesh"):
            TS.shard(x, "dp", "tp")                     # would place


# ---------------------------------------------------------------------------
# the primitives on 4 gloo processes
# ---------------------------------------------------------------------------


def _gloo_worker(rank: int, out: str, port: int) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    from repro_torch.dist import sharding as TS
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.attention import write_slot
    res = {}

    def check(name, ok):
        res[name] = bool(ok)

    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 6, 4, generator=g)
    mesh = make_debug_mesh((2, 2), ("data", "model"))
    with TS.use_mesh(mesh):
        d = TS.shard(x, "dp", None, "tp")
        dr, mr = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        check("place_local", torch.equal(d.to_local(),
                                         x[dr * 4:(dr + 1) * 4, :,
                                           mr * 2:(mr + 1) * 2]))
        check("place_full", torch.equal(d.full_tensor(), x))
        check("spec_of", TS.spec_of(d) == ("data", None, "model"))
        check("redistribute", torch.equal(
            TS.place(d, (None, "model", None)).full_tensor(), x))
        check("identity", TS.shard(x[:, :, :1], "dp", None, "tp").to_local(
            ).shape == (4, 6, 1))

        # shard_map: axis_index, psum, pmean, pmax
        def body(t):
            i = TS.axis_index("model")
            return (TS.psum(t, "model"), TS.pmean(t * (i + 1), "model"),
                    TS.pmax(t + i, "model"))
        s, m, mx = TS.shard_map(body, mesh, (("data", "model"),),
                                (("data", None), ("data", None),
                                 ("data", None)))(torch.ones(4, 4))
        check("psum", torch.equal(s.full_tensor(), torch.full((4, 2), 2.)))
        check("pmean", torch.equal(m.full_tensor(),
                                   torch.full((4, 2), 1.5)))
        check("pmax", torch.equal(mx.full_tensor(), torch.full((4, 2), 2.)))

        # all_to_all: split 0 / concat 1 and back, as jax's tiled form
        blk = torch.arange(4 * 3 * 2, dtype=torch.float32).reshape(4, 3, 2)
        mine = blk + 100 * mr
        y = TS.all_to_all(mine, "model", split_axis=0, concat_axis=1)
        want = torch.cat([blk[mr * 2:(mr + 1) * 2] + 100 * j
                          for j in range(2)], dim=1)
        check("all_to_all", torch.equal(y, want))
        check("all_to_all_back", torch.equal(
            TS.all_to_all(y, "model", split_axis=1, concat_axis=0), mine))

        # write_slot on a cache sharded on its slots
        cache = TS.place(torch.zeros(2, 8, 1, 2), (None, "model"))
        write_slot(cache, torch.ones(2, 1, 1, 2), torch.tensor([5]))
        full = cache.full_tensor()
        check("write_slot", full[:, 5].eq(1).all() and full.sum() == 4)

        # gradients through shard_map: an input replicated over an axis
        # the body is split on gets the sum of the ranks' shares
        w = torch.randn(6, 4, generator=g, requires_grad=True)
        xs = torch.randn(8, 6, generator=g)
        w_d = TS.place(w.detach(), (None, None)).requires_grad_()
        sums = TS.shard_map(lambda a, b: (a @ b).sum()[None], mesh,
                            (("data", None), (None, None)), ("data",))(
            TS.place(xs, ("data", None)), w_d)
        sums.sum().backward()
        (xs @ w).sum().backward()
        check("grad_partial", torch.allclose(w_d.grad.full_tensor(), w.grad,
                                             atol=1e-5))

    mesh3 = make_debug_mesh((2, 2, 1), ("pod", "data", "model"))
    with TS.use_mesh(mesh3):
        d = TS.shard(x, "dp", None, "tp")
        i = 2 * mesh3.get_local_rank("pod") + mesh3.get_local_rank("data")
        check("tuple_entry", TS.spec_of(d) == (("pod", "data"), None, None)
              and torch.equal(d.to_local(), x[2 * i:2 * i + 2]))
        check("tuple_full", torch.equal(d.full_tensor(), x))
    if rank == 0:
        Path(out).write_text(json.dumps(res))
    dist.destroy_process_group()


def run_gloo(out: Path) -> None:
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_gloo_worker, args=(str(out), port), nprocs=4)


GLOO_CHECKS = ("place_local", "place_full", "spec_of", "redistribute",
               "identity", "psum", "pmean", "pmax", "all_to_all",
               "all_to_all_back", "write_slot", "grad_partial",
               "tuple_entry", "tuple_full")


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo") / "checks.json"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, str(Path(__file__)), "gloo",
                           str(out)], env=env, capture_output=True,
                          text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("check", GLOO_CHECKS)
def test_primitives_on_a_gloo_mesh(gloo, check):
    assert gloo[check], check


if __name__ == "__main__":
    side, out = sys.argv[1:3]
    (run_reference if side == "reference" else run_gloo)(Path(out))
