"""The port's configs and layers against the JAX package's, on the CPU.

Configs: all ten architectures, ``tiny_config`` for each, the cells and
``LONG_CONTEXT_ARCHS`` equal field by field (exact); ``param_dtype`` gives
the torch twin of the JAX dtype; ``input_specs`` gives meta tensors of the
reference's shapes.  Layers: ``apply_norm`` (three kinds), ``apply_rope``,
``apply_mrope`` and the three MLPs on the same float32 inputs, at
atol = rtol = 1e-5 (float32, sums in another order).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.launch.train import tiny_config as jax_tiny_config
from repro.models import layers as JL
import repro_torch.configs as TC
from repro_torch.launch.train import tiny_config
from repro_torch.models import layers as TL

TOL = dict(atol=1e-5, rtol=1e-5)


def _fields(cfg):
    """A config as a plain dict, sub-configs included."""
    return {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for k, v in ((f.name, getattr(cfg, f.name))
                         for f in dataclasses.fields(cfg))}


# the port's own fields of ``MoEConfig``, at the values that compute the
# JAX package's function (renormalised gates, gated shared experts)
PORT_ONLY_MOE = {"renormalize": True, "shared_gated": True}


def _port_fields(cfg):
    """``_fields`` of a port config, its port-only fields checked at those
    values and then left out, as the JAX package's config has none."""
    out = _fields(cfg)
    if out["moe"] is not None:
        assert {k: out["moe"].pop(k) for k in PORT_ONLY_MOE} == PORT_ONLY_MOE
    return out


@pytest.mark.parametrize("name", sorted(JC.ARCHS))
def test_config_and_tiny_config_equal_field_by_field(name):
    want, got = JC.get_config(name), TC.get_config(name)
    assert _port_fields(got) == _fields(want)
    assert (got.head_dim if got.n_heads else 0) == (
        want.head_dim if want.n_heads else 0)
    assert got.padded_vocab == want.padded_vocab
    assert list(got.layer_windows()) == list(want.layer_windows())
    assert _port_fields(tiny_config(got)) == _fields(jax_tiny_config(want))
    assert _port_fields(tiny_config(got, vocab=300)) == _fields(
        jax_tiny_config(want, vocab=300))
    assert str(got.param_dtype()).split(".")[-1] == str(want.param_dtype())


def test_registry_cells_and_long_context_set_match():
    assert sorted(TC.ARCHS) == sorted(JC.ARCHS)
    assert [dataclasses.asdict(c) for c in TC.ALL_CELLS] == [
        dataclasses.asdict(c) for c in JC.ALL_CELLS]
    assert TC.LONG_CONTEXT_ARCHS == JC.LONG_CONTEXT_ARCHS
    for name in JC.ARCHS:
        for cell in JC.ALL_CELLS:
            assert TC.cell_applicable(TC.get_config(name),
                                      TC.CELLS_BY_NAME[cell.name]) == \
                JC.cell_applicable(JC.get_config(name), cell)
    with pytest.raises(KeyError):
        TC.get_config("no-such-arch")


@pytest.mark.parametrize("name", ["qwen2-vl-7b", "whisper-small",
                                  "qwen2-0.5b"])
@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_are_meta_tensors_of_the_reference_shapes(name, cell):
    want = JC.input_specs(JC.get_config(name), JC.CELLS_BY_NAME[cell])
    got = TC.input_specs(TC.get_config(name), TC.CELLS_BY_NAME[cell])
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].device.type == "meta"
        assert tuple(got[key].shape) == tuple(want[key].shape)
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparametric_ln"])
def test_apply_norm_matches(kind):
    x = _x((2, 5, 24), 1) * 3 + 0.5
    scale, bias = 1 + _x((24,), 2) * 0.1, _x((24,), 3) * 0.1
    params = {"rmsnorm": {"scale": scale},
              "layernorm": {"scale": scale, "bias": bias},
              "nonparametric_ln": {}}[kind]
    want = JL.apply_norm(kind, {k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x))
    norm = TL.Norm(kind, 24, torch.float32, "cpu")
    with torch.no_grad():
        for k, v in params.items():
            getattr(norm, k).copy_(torch.from_numpy(v))
        got = norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches(theta):
    x = _x((2, 7, 3, 16), 4)
    pos = np.broadcast_to(np.arange(3, 10), (2, 7)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_apply_mrope_matches():
    x = _x((2, 7, 3, 16), 5)
    p = np.arange(7)
    pos = np.broadcast_to(np.stack([p, p // 2, p % 3])[:, None],
                          (3, 2, 7)).astype(np.int32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, (2, 3, 3))
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                         (2, 3, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlps_match(kind):
    x = _x((2, 5, 16), 6)
    mlp = TL.MLP(kind, 16, 40, torch.float32, "cpu",
                 torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in mlp.named_parameters():
            if name.startswith("b_"):
                p.copy_(torch.from_numpy(_x(tuple(p.shape), 7) * 0.1))
        got = mlp(torch.from_numpy(x))
    params = {n: jnp.asarray(p.detach().numpy())
              for n, p in mlp.named_parameters()}
    want = JL.apply_mlp(kind, params, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
