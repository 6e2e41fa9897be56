"""The port's training path against the JAX package's, on the CPU.

* ``Model.loss_fn`` of all ten architectures at ``tiny_config`` (the
  training CLI's, float32) on tests/test_models.py's kind of batch
  (tokens, their roll as targets, random frames for whisper, M-RoPE
  positions for qwen2-vl), weights carried across with
  ``params_from_reference`` (biases and norm scales perturbed so that
  their paths compute something): the loss, ``ce`` and ``aux`` and every
  parameter's gradient, mapped back onto the reference's tree with
  ``params_to_reference``, against ``jax.value_and_grad`` of
  ``repro.models.model.loss_fn``.  Tolerance: a loss to 1e-5 relative; a
  gradient leaf to 1e-4 of its largest magnitude (``GRAD_REL``: float32
  sums in other orders, the Mamba-1 scan sequential where the reference's
  is associative, and a leaf's small elements are sums whose terms cancel,
  so an element-wise relative bound would measure the cancellation).
* ``remat`` on against off: equal, bit for bit.

tests/test_torch_train_step.py holds the train step, the optimizer, the
data pipeline, checkpoints, sharding and the training CLI.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.train import tiny_config as jtiny_config
from repro.models import model as JM
from repro_torch.models.convert import params_from_reference, params_to_reference

from test_torch_models import perturb, port_config

ARCHS = ("qwen2-0.5b", "olmo-1b", "granite-20b", "gemma3-12b", "qwen2-vl-7b",
         "falcon-mamba-7b", "zamba2-1.2b", "granite-moe-3b-a800m",
         "qwen2-moe-a2.7b", "whisper-small")
B, S = 2, 16
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4


def make_batch(cfg, seed: int = 1, batch: int = B, seq: int = S) -> dict:
    """Numpy batch as tests/test_models.py builds one: tokens, targets =
    tokens rolled by one, random frames for whisper, M-RoPE positions."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    out = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (batch, cfg.encdec.n_encoder_ctx, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["mrope_positions"] = np.broadcast_to(
            np.arange(seq, dtype=np.int32), (3, batch, seq)).copy()
    return out


def setup_arch(arch: str, seed: int = 0):
    """(reference config, reference params as numpy, the port's model)."""
    jcfg = jtiny_config(jget_config(arch))
    tree = perturb(jax.tree.map(np.asarray, JM.init_params(
        jax.random.PRNGKey(seed), jcfg)), np.random.default_rng(seed))
    return jcfg, tree, params_from_reference(tree, port_config(jcfg), "cpu")


def flat(tree, prefix=""):
    for key, val in sorted(tree.items()):
        if isinstance(val, dict):
            yield from flat(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(val, np.float32)


def assert_leaf_close(name, got, want, rel=GRAD_REL):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (f"{name}: max abs err {err:.3g} over max "
                                f"|want| {scale:.3g}")


@pytest.fixture(scope="module", params=ARCHS)
def loss_and_grads(request):
    jcfg, tree, model = setup_arch(request.param)
    batch = make_batch(jcfg)
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b), has_aux=True))
    (jl, jm), jg = vg(jax.tree.map(jnp.asarray, tree),
                      {k: jnp.asarray(v) for k, v in batch.items()})
    loss, tm = model.loss_fn({k: torch.from_numpy(v)
                              for k, v in batch.items()})
    loss.backward()
    return dict(jax=(float(jl), {k: float(v) for k, v in jm.items()},
                     dict(flat(jax.tree.map(np.asarray, jg)))),
                torch=(loss.item(), {k: v.item() for k, v in tm.items()},
                       dict(flat(params_to_reference(model, grads=True)))),
                model=model, batch=batch, cfg=jcfg)


def test_loss_ce_and_aux_match_the_reference(loss_and_grads):
    jl, jm, _ = loss_and_grads["jax"]
    tl, tm, _ = loss_and_grads["torch"]
    assert tl == pytest.approx(jl, rel=LOSS_RTOL)
    assert tm["ce"] == pytest.approx(jm["ce"], rel=LOSS_RTOL)
    assert tm["aux"] == pytest.approx(jm["aux"], rel=LOSS_RTOL, abs=1e-7)
    if loss_and_grads["cfg"].moe is not None:
        assert tm["aux"] > 0


def zero_gradient_leaf(cfg, name: str) -> bool:
    """Leaves whose exact gradient is 0: without rotary positions
    (whisper) a key bias adds the same q . b to every score of a query
    row, which the softmax cancels, so ``attn.bk`` and ``cross.bk`` get 0
    up to float32 noise (about 1e-9 on either side)."""
    return cfg.family == "audio" and name.endswith((".attn.bk", ".cross.bk"))


def test_every_gradient_matches_jax_grad(loss_and_grads):
    _, _, jg = loss_and_grads["jax"]
    _, _, tg = loss_and_grads["torch"]
    cfg = loss_and_grads["cfg"]
    assert sorted(tg) == sorted(jg)
    for name in jg:
        assert tg[name].shape == jg[name].shape, name
        if zero_gradient_leaf(cfg, name):
            assert np.abs(jg[name]).max() < 1e-6, name
            assert np.abs(tg[name]).max() < 1e-6, name
            continue
        assert_leaf_close(name, tg[name], jg[name])


@pytest.mark.parametrize("arch", ("granite-moe-3b-a800m", "falcon-mamba-7b",
                                  "whisper-small", "zamba2-1.2b"))
def test_remat_changes_no_gradient(arch):
    """Recomputing each period in the backward pass gives the same loss
    and gradients, bit for bit on the CPU."""
    jcfg, _, model = setup_arch(arch)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(jcfg).items()}
    out = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        loss, m = model.loss_fn(batch, remat=remat)
        loss.backward()
        out.append((loss.detach(), m["aux"].detach(),
                    {k: p.grad.clone() for k, p in model.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    for k in out[0][2]:
        assert torch.equal(out[0][2][k], out[1][2][k]), k
