"""The port's training step and its parts against the JAX package's, on
the CPU (tests/test_torch_train.py holds ``Model.loss_fn``'s gradients).

* ``n_micro`` 1 against 2 (one step: the loss, grad norm and first
  moments), and three ``train_step``s of qwen2-0.5b, falcon-mamba-7b,
  granite-moe-3b-a800m and whisper-small (two microbatches, remat on)
  tracking the reference's jitted ``make_train_step`` in ce, aux, loss, lr
  and grad norm (``STEP_TOL``) and in the working params after them.
* ``apply_updates`` against the reference's, term for term: the working
  params (bf16 among them), master, m, v, lr and grad norm, with and
  without clipping, over several steps; the lr schedule.
* ``DataPipeline(n_workers=1)`` batches equal to the reference's; a
  checkpoint round trip bit-exact for bf16, atomicity and gc;
  ``pick_n_micro`` over every config; ``spec_for``'s fallback and
  ``shard``'s identity under meshes described by name and shape;
  ``head_layout`` under ``duplicated_kv`` at tp 2, 4 and 16.
* the training CLI at tiny scale on the CPU: as two subprocesses
  (``launch.train_smoke``: 10 steps with checkpoints, then a resumed run
  to 15), and in process for the families with modality inputs.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.dist import sharding as JS
from repro.models import attention as JA
from repro.train import optim as JO
from repro.train import step as JSTEP
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import DataPipeline as JDataPipeline
from repro_torch.configs import get_config
from repro_torch.dist import sharding as TS
from repro_torch.models import attention as TA
from repro_torch.models.convert import params_from_reference, params_to_reference
from repro_torch.train import checkpoint as TCK
from repro_torch.train import optim as TO
from repro_torch.train import step as TSTEP
from repro_torch.train.data import DataConfig, DataPipeline

from test_torch_models import port_config
from test_torch_train import assert_leaf_close, flat, make_batch, setup_arch

ROOT = Path(__file__).resolve().parents[1]
STEP_ARCHS = ("qwen2-0.5b", "falcon-mamba-7b", "granite-moe-3b-a800m",
              "whisper-small")
# train steps: step 1 as the loss; later steps start from parameters that
# AdamW moved by about lr per element, where an element whose gradient is
# near 0 moves by +-lr on either side by the sign of a rounding error, so
# the losses and norms drift apart a little more each step
STEP_TOL = (1e-5, 1e-4, 1e-4)


def _port_steps(model, batches, ocfg, **kw):
    step = TSTEP.make_train_step(model, ocfg, **kw)
    state = TO.init_opt_state(dict(model.named_parameters()))
    out = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        out.append({k: float(v) for k, v in m.items()})
    return out, state


def test_n_micro_two_equals_one_for_a_dense_model():
    """Two microbatches of a dense model give the mean of the same
    per-token losses: the same loss and, within float32 rounding, the same
    gradients and step."""
    jcfg, tree, m1 = setup_arch("qwen2-0.5b")
    m2 = params_from_reference(tree, port_config(jcfg), "cpu")
    ocfg = TO.AdamWConfig(warmup_steps=5, decay_steps=10)
    batches = [make_batch(jcfg, seed=1, batch=4)]
    r1, s1 = _port_steps(m1, batches, ocfg, n_micro=1, remat=False,
                         ce_chunks=2)
    r2, s2 = _port_steps(m2, batches, ocfg, n_micro=2, remat=False,
                         ce_chunks=2)
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert r2[0][k] == pytest.approx(r1[0][k], rel=1e-5), k
    # the first moment after one step is (1 - beta1) times the clipped
    # gradient (the update itself divides by sqrt(v) and turns the sign
    # of a near-zero gradient's rounding error into +-lr)
    for k in s1.m:
        assert_leaf_close(k, s2.m[k].numpy(), s1.m[k].numpy(), rel=1e-5)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_three_train_steps_track_the_reference(arch):
    jcfg, tree, model = setup_arch(arch)
    kw = dict(n_micro=2, remat=True, ce_chunks=2)
    batches = [make_batch(jcfg, seed=s, batch=4) for s in (1, 2, 3)]
    jstep = jax.jit(JSTEP.make_train_step(
        jcfg, JO.AdamWConfig(warmup_steps=5, decay_steps=10), **kw))
    params = jax.tree.map(jnp.asarray, tree)
    state = JO.init_opt_state(params)
    want = []
    for b in batches:
        params, state, m = jstep(params, state,
                                 {k: jnp.asarray(v) for k, v in b.items()})
        want.append({k: float(v) for k, v in m.items()})
    got, _ = _port_steps(model, batches,
                         TO.AdamWConfig(warmup_steps=5, decay_steps=10), **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert g[k] == pytest.approx(w[k], rel=STEP_TOL[i]), (i, k)
        assert g["aux"] == pytest.approx(w["aux"], rel=STEP_TOL[i], abs=1e-7)
    # the working params after three steps
    tp = dict(flat(params_to_reference(model)))
    for name, val in flat(jax.tree.map(np.asarray, params)):
        assert_leaf_close(name, tp[name], val, rel=1e-3)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def _opt_tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "e": rng.standard_normal((4, 3, 2)).astype(np.float32),
            "h": rng.standard_normal((8, 4)).astype(np.float32)}


@pytest.mark.parametrize("clip", (1.0, None))
def test_apply_updates_matches_the_reference(clip):
    cfg_kw = dict(lr_peak=1e-2, lr_min=1e-3, warmup_steps=2, decay_steps=6,
                  clip_norm=clip)
    tree = _opt_tree(0)
    jp = {k: jnp.asarray(v) for k, v in tree.items()}
    jp["h"] = jp["h"].astype(jnp.bfloat16)       # a bf16 working param
    tp = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    tp["h"] = tp["h"].to(torch.bfloat16)
    jstate, tstate = JO.init_opt_state(jp), TO.init_opt_state(tp)
    for step in range(5):
        g = _opt_tree(10 + step)
        scale = 50.0 if step % 2 == 0 else 0.1   # clipped, then not
        jp, jstate, jm = JO.apply_updates(
            jp, {k: jnp.asarray(v * scale) for k, v in g.items()}, jstate,
            JO.AdamWConfig(**cfg_kw))
        tp, tstate, tm = TO.apply_updates(
            tp, {k: torch.from_numpy(v * scale) for k, v in g.items()},
            tstate, TO.AdamWConfig(**cfg_kw))
        assert int(tstate.step) == int(jstate.step) == step + 1
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        for k in tree:
            for t, j in ((tstate.master[k], jstate.master[k]),
                         (tstate.m[k], jstate.m[k]),
                         (tstate.v[k], jstate.v[k])):
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-5, atol=1e-7)
            assert tp[k].dtype == (torch.bfloat16 if k == "h"
                                   else torch.float32)
            # the working params: the master cast to their dtype
            torch.testing.assert_close(tp[k], tstate.master[k].to(tp[k].dtype))
            np.testing.assert_allclose(
                tp[k].float().numpy(), np.asarray(jp[k], np.float32),
                rtol=1e-2 if k == "h" else 1e-5, atol=1e-7)


def test_decay_only_on_matrices_and_clip_bounds_the_update():
    """Zero gradients: only the matrix decays; a huge gradient is
    measured before clipping, and its update is the clipped one's."""
    p = {"w": torch.ones(3, 3), "b": torch.ones(3)}
    cfg = TO.AdamWConfig(lr_peak=0.1, warmup_steps=0, weight_decay=0.5)
    p, st, _ = TO.apply_updates(p, {k: torch.zeros_like(v)
                                    for k, v in p.items()},
                                TO.init_opt_state(p), cfg)
    assert torch.all(p["w"] < 1) and torch.all(p["b"] == 1)
    p = {"w": torch.zeros(3)}
    _, st, m = TO.apply_updates(p, {"w": torch.tensor([1e6, 0.0, 0.0])},
                                TO.init_opt_state(p),
                                TO.AdamWConfig(clip_norm=1.0,
                                               warmup_steps=0))
    assert float(m["grad_norm"]) > 1e5
    assert float(st.m["w"][0]) == pytest.approx(0.1, rel=1e-6)


def test_lr_schedule_matches_the_reference():
    cfg = dict(lr_peak=1.0, lr_min=0.1, warmup_steps=10, decay_steps=100)
    for s in (0, 1, 5, 9, 10, 11, 55, 99, 100, 150):
        want = float(JO.lr_at(JO.AdamWConfig(**cfg), jnp.int32(s)))
        got = float(TO.lr_at(TO.AdamWConfig(**cfg),
                             torch.tensor(s, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), s


def test_sharding_functions_are_the_identity_without_a_mesh():
    sh = {"w": None}
    assert TO.zero1_shardings(sh, {"w": torch.zeros(4)}) is sh
    assert TO.opt_state_shardings(sh).m is sh


# ---------------------------------------------------------------------------
# data, checkpoints, microbatches
# ---------------------------------------------------------------------------


def test_data_pipeline_batches_equal_the_reference():
    got, want = [], []
    for cls, cfg_cls, out in ((DataPipeline, DataConfig, got),
                              (JDataPipeline, JDataConfig, want)):
        cfg = cfg_cls(batch_size=2, seq_len=32, n_workers=1, queue_depth=2,
                      seed=3)
        with cls(cfg, vocab_size=300) as pipe:
            out.extend(pipe.batches(3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def _ckpt_tree():
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(3, 4, generator=g).to(torch.bfloat16),
              "b": torch.randn(5, generator=g)}
    state = TO.init_opt_state(params)
    state.m["a"].normal_(generator=g)
    return {"params": params, "opt": TO.OptState(
        torch.tensor(7, dtype=torch.int32), state.master, state.m, state.v)}


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    tree = _ckpt_tree()
    TCK.save(tmp_path, 7, tree)
    like = {"params": {k: torch.zeros_like(v)
                       for k, v in tree["params"].items()},
            "opt": TO.init_opt_state(tree["params"])}
    step, got = TCK.restore_latest(tmp_path, like)
    assert step == 7 and isinstance(got["opt"], TO.OptState)
    for (k, a), (_, b) in zip(TCK._flatten(tree), TCK._flatten(got)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    manifest = (tmp_path / "step_00000007" / "manifest.json").read_text()
    assert '"dtype": "bfloat16"' in manifest


def test_checkpoint_atomicity_and_gc(tmp_path):
    w = TCK.AsyncCheckpointer(tmp_path, keep=2)
    x = torch.zeros(4)
    for s in (1, 2, 3, 4):
        x.fill_(s)
        w.save_async(s, {"x": x})     # x changes right after: a snapshot
    w.close()
    assert TCK.latest_step(tmp_path) == 4
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir()
                   if p.name.startswith("step_"))
    assert steps == [3, 4]
    _, got = TCK.restore_latest(tmp_path, {"x": x})
    assert torch.equal(got["x"], torch.full((4,), 4.0))
    (tmp_path / ".tmp_step_00000009").mkdir()     # a crashed write
    (tmp_path / "step_00000008").mkdir()          # no manifest: incomplete
    assert TCK.latest_step(tmp_path) == 4


def test_pick_n_micro_matches_the_reference_for_every_config():
    for name in sorted(JARCHS):
        for batch, seq in ((256, 4096), (8, 512), (32, 32768), (6, 128)):
            assert TSTEP.pick_n_micro(get_config(name), batch, seq) == \
                JSTEP.pick_n_micro(jget_config(name), batch, seq), name


def test_to_micro_splits_like_the_reference():
    b = {"tokens": np.arange(24).reshape(4, 6),
         "mrope_positions": np.arange(72).reshape(3, 4, 6)}
    got = TSTEP.to_micro({k: torch.from_numpy(v) for k, v in b.items()}, 2)
    assert torch.equal(got[1]["tokens"], torch.from_numpy(b["tokens"][2:]))
    assert torch.equal(got[0]["mrope_positions"],
                       torch.from_numpy(b["mrope_positions"][:, :2]))


# ---------------------------------------------------------------------------
# sharding and the head layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _TorchMesh:
    """What the port reads of a DeviceMesh."""
    mesh_dim_names: tuple
    shape: tuple


class _JaxMesh:
    """What the reference reads of a jax Mesh."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.devices = np.zeros(shape)


MESHES = [(("data", "model"), (2, 4)), (("data", "model"), (4, 1)),
          (("pod", "data", "model"), (2, 2, 2)), (("data", "model"), (1, 8))]
AXES = [("dp", "tp"), ("tp", "dp"), ("dp", None, "tp"), (("dp", "tp"),),
        ("sp", "tp"), ("tp", "tp"), (None, "dp")]
SHAPES = [(8, 8, 8), (3, 4, 6), (2, 16, 5), (16, 2, 12), (1, 1, 1)]


@pytest.mark.parametrize("names,shape", MESHES)
def test_spec_for_falls_back_as_the_reference_does(names, shape):
    with TS.use_mesh(_TorchMesh(names, shape)) as tctx, \
            JS.use_mesh(_JaxMesh(names, shape)) as jctx:
        assert (tctx.tp, tctx.dp) == (jctx.tp, jctx.dp)
        assert tctx.pspec("dp", "tp", None) == tuple(jctx.pspec("dp", "tp",
                                                                None))
        for seq in (False, True):
            with TS.sequence_sharding(seq), JS.sequence_sharding(seq):
                for ax in AXES:
                    for shp in SHAPES:
                        got = TS.spec_for(shp[:max(len(ax), 1)], *ax)
                        want = JS.spec_for(shp[:max(len(ax), 1)], *ax)
                        assert got == tuple(want), (ax, shp, seq)


def test_shard_is_the_identity_or_raises():
    x = torch.ones(4, 6)
    assert not TS.current().active
    assert TS.shard(x, "dp", "tp") is x
    with TS.use_mesh(_TorchMesh(("data", "model"), (1, 1))):
        assert TS.shard(x, "dp", "tp") is x         # every axis size 1
    with TS.use_mesh(_TorchMesh(("data", "model"), (2, 3))):
        assert TS.shard(torch.ones(3, 5), "dp", "tp") is not None
        with pytest.raises(TypeError, match="DeviceMesh"):
            TS.shard(x, "dp", "tp")


@pytest.mark.parametrize("tp", (2, 4, 16))
@pytest.mark.parametrize("dup", (False, True))
def test_head_layout_under_duplicated_kv(tp, dup):
    for name in sorted(JARCHS):
        cfg = jget_config(name)
        if not cfg.n_heads:
            continue
        args = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, tp)
        with TA.duplicated_kv(dup), JA.duplicated_kv(dup):
            assert dataclasses.asdict(TA.head_layout(*args)) == \
                dataclasses.asdict(JA.head_layout(*args)), name
    with TA.duplicated_kv():
        assert TA.head_layout(14, 2, 64) == TA.head_layout(14, 2, 64, 1)
        assert TA.head_layout(14, 2, 64, 4).kv_store == 4


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------


def test_train_cli_on_the_cpu_checkpoints_and_resumes():
    """``python -m repro_torch.launch.train_smoke --device cpu``: the
    training CLI as a subprocess at tiny scale (olmo-1b), 10 steps with
    checkpoints every 5, then a second process that resumes from step 10
    and continues to 15 (the twin of ``examples/train_smoke.py``)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_smoke", "--device",
         "cpu"], capture_output=True, text=True, timeout=300, env=env,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = proc.stdout
    assert out.count("[train] arch=olmo-1b scale=tiny") == 2
    losses = [float(x.split("loss=")[1].split()[0])
              for x in out.splitlines() if "loss=" in x]
    assert len(losses) == 3 and all(np.isfinite(losses))   # steps 5, 10, 15
    assert "latest=10" in out and "latest=15" in out
    assert "resumed from step 10" in out and "step=15" in out
    assert out.count("flash_fwd=0 flash_bwd=0") == 2   # no kernel on the CPU
    assert "train + crash-resume ok" in out


@pytest.mark.parametrize("arch", ("whisper-small", "qwen2-vl-7b",
                                  "falcon-mamba-7b"))
def test_train_cli_feeds_every_family(arch, capsys):
    """``launch.train`` in process for the families with modality inputs
    (whisper's frames, qwen2-vl's M-RoPE positions) and the scan."""
    from repro_torch.launch import train
    train.main(["--device", "cpu", "--arch", arch, "--steps", "2",
                "--batch", "2", "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    losses = [float(x.split("loss=")[1].split()[0])
              for x in out.splitlines() if "loss=" in x]
    assert len(losses) == 2 and all(np.isfinite(losses)), out
    assert "[train] done" in out


def test_train_cli_without_a_card_fails(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train.main(["--steps", "1"])
