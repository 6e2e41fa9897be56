"""The port under a mesh against the JAX package under the same mesh.

Both sides run the ten architectures' ``tiny`` configs on a (2, 2) and a
(1, 4) ("data", "model") mesh of four ranks: the reference in a
subprocess on 4 host devices (``XLA_FLAGS`` set before jax starts) with
an Auto-axes mesh that this file builds (``repro.launch.mesh`` builds
Explicit axes on jax 0.9.0, whose ``with_sharding_constraint`` refuses
every placing spec), the port in 4 gloo processes on the CPU.  The
reference's weights (numpy-seeded biases and norm scales on top of
``init_params``) cross by ``params_from_reference``; the port places them
with ``place_params``.  Compared, within 1e-4:

* prefill logits and one ``decode_step`` from the grown, placed cache,
  with identical greedy tokens;
* one more ``decode_step`` from a cache of ``SLOTS`` slots, a count that
  the tensor axis divides, for the cases whose kv heads it does not
  divide (qwen2 and granite-20b, and gemma3 with 2 kv heads for its
  window rings): their caches are sharded on the slot axis, so B2 runs
  on each rank's slots and the ranks merge by log-sum-exp;
* the moe's two bodies (``_moe_a2a_body`` at S = 8, ``_moe_replicated_body``
  at S = 3) against ``repro.models.moe.moe_apply``, each shown taken by
  ``repro_torch.models.moe.BODY_CALLS`` (1e-5);
* on (2, 2), one ZeRO-1 train step of qwen2 ``tiny`` against the
  reference's jitted ``make_train_step`` with ``zero1_shardings``: loss,
  updated parameters and the moments ``m`` and ``v``.

Each mesh runs as two subprocesses (reference, then port), once for the
file; the tests read their outputs.  Run as a script, this file is those
subprocesses: ``python tests/test_torch_sharded.py reference|port MESH
DIR``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
ARCHS = ("qwen2-0.5b", "olmo-1b", "granite-20b", "gemma3-12b", "qwen2-vl-7b",
         "falcon-mamba-7b", "zamba2-1.2b", "granite-moe-3b-a800m",
         "qwen2-moe-a2.7b", "whisper-small")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, S = 4, 8
SLOTS = S + 4           # divides the tensor axis of both meshes
# case -> kv heads, or None for the arch's tiny config's own
SLOT_CASES = {"qwen2-0.5b": None, "granite-20b": None, "gemma3-12b/kv2": 2}
CASES = ARCHS + tuple(c for c in SLOT_CASES if c not in ARCHS)
MOE_SEQS = {"a2a": 8, "replicated": 3}
TOL = dict(atol=1e-4, rtol=1e-4)
MOE_TOL = dict(atol=1e-5, rtol=1e-5)
TIMEOUT = 240


# ---------------------------------------------------------------------------
# shared: inputs and trees
# ---------------------------------------------------------------------------


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _unflat(flat, prefix):
    tree: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _perturb(tree, rng):
    """Biases to N(0, 0.1) and norm scales to 1 + N(0, 0.1) (as
    ``test_torch_models`` does), so that they count."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _perturb(val, rng)
        elif key in ("bq", "bk", "bv", "bias", "b_up", "b_down"):
            out[key] = rng.normal(0.0, 0.1, val.shape).astype(val.dtype)
        elif key == "scale":
            out[key] = (1.0 + rng.normal(0.0, 0.1, val.shape)).astype(
                val.dtype)
        else:
            out[key] = val
    return out


def _inputs(cfg_family, vocab, d_model, n_ctx, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    pre, dec = {}, {}
    if cfg_family == "vlm":
        p = np.arange(S + 1)
        thw = np.stack([p, p // 2, p % 3]).astype(np.int32)
        thw = np.broadcast_to(thw[:, None], (3, B, S + 1)).copy()
        pre["mrope_positions"] = thw[:, :, :S].copy()
        dec["mrope_positions"] = thw[:, :, S:].copy()
    if cfg_family == "audio":
        pre["frames"] = rng.standard_normal((B, n_ctx, d_model)).astype(
            np.float32)
    return toks, pre, dec


def _grow(cache, shapes):
    """A prefill cache zero-padded at the end of every axis to ``shapes``
    (``cache_specs``' shapes: the attention K/V grow on their sequence
    axis; window rings, ssm states and the cross K/V keep theirs)."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out[k] = _grow(v, shapes[k])
        else:
            v = np.asarray(v)
            out[k] = np.pad(v, [(0, n - m) for m, n in zip(v.shape,
                                                          shapes[k])])
    return out


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def _case_config(case, tiny):
    """A case's config: the arch's ``tiny``, with its kv heads replaced
    where ``SLOT_CASES`` says."""
    cfg = tiny(case.split("/")[0])
    kv = SLOT_CASES.get(case)
    return cfg if kv is None else dataclasses.replace(cfg, n_kv_heads=kv)


def _cache_sizes(case):
    """The cache lengths a case decodes from: the prefill's grown by one
    slot, and for a slot case also ``SLOTS``."""
    return (S + 1,) + ((SLOTS,) if case in SLOT_CASES else ())


def _dkey(n):
    return "dlogits" if n == S + 1 else f"dlogits{n}"


# ---------------------------------------------------------------------------
# the reference side (a subprocess on 4 host devices)
# ---------------------------------------------------------------------------


def _ocfg(mod):
    """AdamW at lr 2e-3: the step moves the weights by about 2e-3, twenty
    times the tolerance.  Adam divides by sqrt(v), so a gradient within a
    few eps of zero turns its float32 rounding (~1e-8 here, summed in
    another order on the mesh) into up to 1.5% of lr; at 2e-3 that stays
    under the tolerance (at 1e-2 it reaches 1.6e-4)."""
    return mod.AdamWConfig(lr_peak=2e-3, warmup_steps=0)


def run_reference(mesh_key: str, out_dir: Path) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding

    sys.path.insert(0, str(HERE))
    from conftest import tiny
    from repro.dist.sharding import use_mesh
    from repro.models import model as JM
    from repro.models import moe as JMOE
    from repro.train import optim as JO
    from repro.train import step as JST

    shape = MESHES[mesh_key]
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out, meta = {}, {}

    def put(tree, shardings):
        return jax.tree.map(lambda x, s: x if s is None
                            else jax.device_put(x, s), tree, shardings)

    with use_mesh(mesh):
        for i, arch in enumerate(CASES):
            cfg = _case_config(arch, tiny)
            meta[arch] = dataclasses.asdict(cfg)
            tree = _perturb(jax.tree.map(np.asarray, JM.init_params(
                jax.random.PRNGKey(i), cfg)), np.random.default_rng(i))
            params = put(jax.tree.map(jnp.asarray, tree),
                         JM.param_shardings(cfg, tree))
            n_ctx = cfg.encdec.n_encoder_ctx if cfg.encdec else 0
            toks, pre, dec = _inputs(cfg.family, cfg.vocab_size, cfg.d_model,
                                     n_ctx, 100 + i)
            logits, cache = jax.jit(JM.prefill, static_argnums=(1,))(
                params, cfg, toks, {k: jnp.asarray(v) for k, v in
                                    pre.items()})
            logits = np.asarray(logits)
            nxt = logits[:, -1, :cfg.vocab_size].argmax(-1).astype(
                np.int32)[:, None]
            cache = jax.tree.map(np.asarray, cache)
            for n in _cache_sizes(arch):
                specs = JM.cache_specs(cfg, B, n)
                grown = put(jax.tree.map(jnp.asarray, _grow(
                    cache, _shapes(specs))), JM.cache_shardings(cfg, specs))
                dlogits, _ = jax.jit(JM.decode_step, static_argnums=(1,))(
                    params, cfg, jnp.asarray(nxt), grown, S,
                    {k: jnp.asarray(v) for k, v in dec.items()})
                out[f"{arch}|{_dkey(n)}"] = np.asarray(dlogits)
            out.update({f"{arch}|params|{k}": v
                        for k, v in _flat(tree).items()})
            out.update({f"{arch}|toks": toks, f"{arch}|logits": logits})
            out.update({f"{arch}|pre|{k}": v for k, v in pre.items()})
            out.update({f"{arch}|dec|{k}": v for k, v in dec.items()})

        # the moe's two bodies
        mcfg = tiny("granite-moe-3b-a800m")
        dims = JMOE.moe_dims(mcfg.moe, mcfg.d_model, shape[1])
        mp = jax.tree.map(np.asarray, JMOE.moe_init(jax.random.PRNGKey(7),
                                                   dims, jnp.float32))
        out.update({f"moe|params|{k}": v for k, v in mp.items()})
        meta["moe"] = dataclasses.asdict(mcfg)
        for body, seq in MOE_SEQS.items():
            x = np.random.default_rng(seq).standard_normal(
                (B, seq, mcfg.d_model)).astype(np.float32)
            y, aux = jax.jit(lambda p, x: JMOE.moe_apply(p, x, dims))(
                jax.tree.map(jnp.asarray, mp), jnp.asarray(x))
            out.update({f"moe|{body}|x": x, f"moe|{body}|y": np.asarray(y),
                        f"moe|{body}|aux": np.asarray(aux)})

        if mesh_key == "2x2":
            cfg = tiny("qwen2-0.5b")
            tree = _perturb(jax.tree.map(np.asarray, JM.init_params(
                jax.random.PRNGKey(11), cfg)), np.random.default_rng(11))
            p_sh = JM.param_shardings(cfg, tree)
            zero1 = JO.zero1_shardings(p_sh, tree)
            rep = NamedSharding(mesh, jax.sharding.PartitionSpec())
            params = put(jax.tree.map(jnp.asarray, tree), p_sh)
            opt = JO.init_opt_state(params)
            opt = JO.OptState(step=jax.device_put(opt.step, rep),
                              master=put(opt.master, zero1),
                              m=put(opt.m, zero1), v=put(opt.v, zero1))
            rng = np.random.default_rng(12)
            batch = {k: rng.integers(0, cfg.vocab_size, (B, 16)).astype(
                np.int32) for k in ("tokens", "targets")}
            step = JST.make_train_step(cfg, _ocfg(JO), n_micro=1, remat=True,
                                       grad_shardings=zero1,
                                       param_shardings=p_sh)
            new_p, new_o, metrics = jax.jit(step)(
                params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
            out.update({f"zero1|params|{k}": v
                        for k, v in _flat(tree).items()})
            out.update({f"zero1|new|{k}": v for k, v in _flat(
                jax.tree.map(np.asarray, new_p)).items()})
            out.update({f"zero1|m|{k}": v for k, v in _flat(
                jax.tree.map(np.asarray, new_o.m)).items()})
            out.update({f"zero1|v|{k}": v for k, v in _flat(
                jax.tree.map(np.asarray, new_o.v)).items()})
            out.update({f"zero1|batch|{k}": v for k, v in batch.items()})
            out["zero1|loss"] = np.asarray(metrics["loss"])
            meta["zero1"] = dataclasses.asdict(cfg)
    np.savez(out_dir / "reference.npz", **out)
    (out_dir / "configs.json").write_text(json.dumps(meta))


# ---------------------------------------------------------------------------
# the port's side (4 gloo processes on the CPU)
# ---------------------------------------------------------------------------


def _port_config(d):
    from repro_torch.configs import base as TB
    d = dict(d)
    for sub, cls in (("moe", TB.MoEConfig), ("ssm", TB.SSMConfig),
                     ("encdec", TB.EncDecConfig)):
        if d[sub] is not None:
            d[sub] = cls(**d[sub])
    for k, v in d.items():
        if isinstance(v, list):
            d[k] = tuple(v)
    return TB.ModelConfig(**d)


def _kv_leaves(tree):
    """The attention caches' K and V tensors of a cache tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _kv_leaves(v)
        elif k in ("k", "v"):
            yield v


def _full(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def _port_worker(rank: int, mesh_key: str, out_dir: str, port: int) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    from repro_torch.dist.sharding import (
        place,
        spec_for,
        spec_of,
        tree_map,
        use_mesh,
    )
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as TM
    from repro_torch.models import moe as TMOE
    from repro_torch.models.convert import params_from_reference
    from repro_torch.train import optim as TO
    from repro_torch.train import step as TST

    out_dir = Path(out_dir)
    ref = dict(np.load(out_dir / "reference.npz"))
    meta = json.loads((out_dir / "configs.json").read_text())
    mesh = make_debug_mesh(MESHES[mesh_key], ("data", "model"))
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    res = {}
    with use_mesh(mesh):
        for arch in CASES:
            cfg = _port_config(meta[arch])
            model = TM.place_params(params_from_reference(
                _unflat(ref, f"{arch}|params|"), cfg, "cpu"))
            pre = {k.split("|")[2]: t(v) for k, v in ref.items()
                   if k.startswith(f"{arch}|pre|")}
            dec = {k.split("|")[2]: t(v) for k, v in ref.items()
                   if k.startswith(f"{arch}|dec|")}
            logits, cache = model.prefill(t(ref[f"{arch}|toks"]), pre)
            logits = _full(logits)
            nxt = logits[:, -1, :cfg.vocab_size].argmax(-1).to(
                torch.int32)[:, None]
            plain = tree_map(lambda c: _full(c).numpy(), cache)
            for n in _cache_sizes(arch):
                specs = TM.cache_specs(cfg, B, n)
                grown = tree_map(t, _grow(plain, _shapes(specs)))
                placed = TM.place_tree(grown, TM.cache_shardings(cfg, specs))
                dlogits, _ = model.decode_step(nxt, placed, S, dec)
                res[f"{arch}|{_dkey(n)}"] = _full(dlogits).numpy()
                # per attention K/V leaf [P, B, Sc, KV, D]: whether its
                # slot axis lies on the tensor axis
                res[f"{arch}|slots_on_tp{n}"] = np.array([
                    "model" in str(spec_of(c)[2]) for c in _kv_leaves(placed)])
            res[f"{arch}|logits"] = logits.numpy()

        mcfg = _port_config(meta["moe"])
        dims = TMOE.moe_dims(mcfg.moe, mcfg.d_model, MESHES[mesh_key][1])
        mp = {k.split("|")[2]: t(v) for k, v in ref.items()
              if k.startswith("moe|params|")}
        mspec = {"router": (None, None)}
        mspec.update({k: spec_for(mp[k].shape, "tp") for k in
                      ("w_gate", "w_up", "w_down")})
        placed_mp = {k: place(v, mspec[k]) for k, v in mp.items()}
        with torch.no_grad():
            for body in MOE_SEQS:
                before = dict(TMOE.BODY_CALLS)
                y, aux = TMOE.moe_apply(placed_mp, t(ref[f"moe|{body}|x"]),
                                        dims)
                res[f"moe|{body}|y"] = _full(y).numpy()
                res[f"moe|{body}|aux"] = _full(aux).numpy()
                res[f"moe|{body}|taken"] = np.array(
                    [TMOE.BODY_CALLS[k] - before[k] for k in
                     ("local", "a2a", "replicated")])

        if "zero1" in meta:
            cfg = _port_config(meta["zero1"])
            model = params_from_reference(_unflat(ref, "zero1|params|"), cfg,
                                          "cpu")
            shapes = TM.param_shapes(cfg)
            p_sh = TM.param_shardings(cfg, shapes)
            zero1 = TO.zero1_shardings(p_sh, shapes)
            TM.place_params(model, p_sh)
            opt = TO.init_opt_state(dict(model.named_parameters()),
                                    TM.port_specs(model, zero1))
            step = TST.make_train_step(model, _ocfg(TO), n_micro=1,
                                       remat=True, grad_shardings=zero1,
                                       param_shardings=p_sh)
            batch = {k: place(t(ref[f"zero1|batch|{k}"]),
                              spec_for((B, 16), "dp"))
                     for k in ("tokens", "targets")}
            new_o, metrics = step(opt, batch)
            res["zero1|loss"] = _full(metrics["loss"]).numpy()
            for name, p in model.named_parameters():
                res[f"zero1|new|{name}"] = _full(p).numpy()
                res[f"zero1|m|{name}"] = _full(new_o.m[name]).numpy()
                res[f"zero1|v|{name}"] = _full(new_o.v[name]).numpy()
    if rank == 0:
        np.savez(out_dir / "port.npz", **res)
    dist.destroy_process_group()


def run_port(mesh_key: str, out_dir: Path) -> None:
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_port_worker, args=(mesh_key, str(out_dir), port), nprocs=4)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides on both meshes: the two references at once, then the
    two ports at once."""
    dirs = {k: tmp_path_factory.mktemp(f"sharded_{k}") for k in MESHES}
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    for side in ("reference", "port"):
        procs = {k: subprocess.Popen(
            [sys.executable, str(Path(__file__)), side, k, str(d)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for k, d in dirs.items()}
        for k, p in procs.items():
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, (side, k, err[-4000:])
    return {k: (dict(np.load(d / "reference.npz")),
                dict(np.load(d / "port.npz"))) for k, d in dirs.items()}


@pytest.mark.parametrize("mesh_key", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference_on_the_mesh(runs, mesh_key,
                                                            arch):
    ref, port = runs[mesh_key]
    for what in ("logits", "dlogits"):
        np.testing.assert_allclose(port[f"{arch}|{what}"],
                                   ref[f"{arch}|{what}"], **TOL)
    vocab = 257
    for what, pos in (("logits", -1), ("dlogits", 0)):
        np.testing.assert_array_equal(
            port[f"{arch}|{what}"][:, pos, :vocab].argmax(-1),
            ref[f"{arch}|{what}"][:, pos, :vocab].argmax(-1))


@pytest.mark.parametrize("mesh_key", MESHES)
@pytest.mark.parametrize("case", SLOT_CASES)
def test_decode_on_a_slot_sharded_cache_matches_the_reference(runs, mesh_key,
                                                              case):
    ref, port = runs[mesh_key]
    key = f"{case}|dlogits{SLOTS}"
    np.testing.assert_allclose(port[key], ref[key], **TOL)
    np.testing.assert_array_equal(port[key][:, 0, :257].argmax(-1),
                                  ref[key][:, 0, :257].argmax(-1))
    # the cache really lay on its slots wherever its kv heads do not
    # split over the tensor axis (on (1, 4): every case)
    kv = SLOT_CASES[case] or {"qwen2-0.5b": 2, "granite-20b": 1}[case]
    on_slots = port[f"{case}|slots_on_tp{SLOTS}"]
    assert on_slots.size > 0
    assert on_slots.all() == bool(kv % MESHES[mesh_key][1]), on_slots
    assert on_slots.all() or not on_slots.any(), on_slots
    if mesh_key == "1x4":
        assert on_slots.all()


@pytest.mark.parametrize("mesh_key", MESHES)
@pytest.mark.parametrize("body", MOE_SEQS)
def test_moe_bodies_match_moe_apply(runs, mesh_key, body):
    ref, port = runs[mesh_key]
    np.testing.assert_allclose(port[f"moe|{body}|y"], ref[f"moe|{body}|y"],
                               **MOE_TOL)
    np.testing.assert_allclose(port[f"moe|{body}|aux"],
                               ref[f"moe|{body}|aux"], **MOE_TOL)
    taken = dict(zip(("local", "a2a", "replicated"),
                     port[f"moe|{body}|taken"]))
    assert taken[body] == 1 and sum(taken.values()) == 1, taken


def test_zero1_train_step_matches_the_reference(runs):
    ref, port = runs["2x2"]
    np.testing.assert_allclose(port["zero1|loss"], ref["zero1|loss"], **TOL)
    names = [k[len("zero1|new|"):] for k in port if k.startswith("zero1|new|")]
    assert names
    for name in names:
        path = name.split(".")
        if path[0] == "stages":             # stages.<stage>.<p>.rest
            key, per = "/".join((path[1],) + tuple(path[3:])), int(path[2])
        else:
            key, per = "/".join(path), None
        for what in ("new", "m", "v"):
            want = ref[f"zero1|{what}|{key}"]
            want = want if per is None else want[per]
            np.testing.assert_allclose(port[f"zero1|{what}|{name}"], want,
                                       err_msg=f"{what} {name}", **TOL)
    # the step moved the weights (the comparison is not of the inputs)
    moved = max(np.abs(ref[f"zero1|new|{k[len('zero1|params|'):]}"]
                       - ref[k]).max() for k in ref
                if k.startswith("zero1|params|"))
    assert moved > 1e-3, moved


if __name__ == "__main__":
    side, mesh_key, out = sys.argv[1:4]
    (run_reference if side == "reference" else run_port)(mesh_key,
                                                         Path(out))
