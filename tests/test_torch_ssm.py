"""The port's state-space blocks (``repro_torch.models.ssm``) against
``repro.models.ssm``, on the CPU.

Mamba-1 at the conftest ``tiny`` falcon-mamba width (d_model 64, d_inner
128, d_state 8, dt_rank 8) and Mamba-2 at the tiny zamba2 width (d_inner
128 as 8 heads of 16, d_state 8), float32.  Weights are the reference's
``ssm_init`` tree as numpy, with ``dt_bias``, ``D`` and ``conv_b`` moved
off their constant initial values so those terms compute something;
inputs come from numpy seeds.  ``causal_conv`` with and without a carried
state, ``mamba1_mix`` (B4's plain version where the reference runs a
chunked associative scan), ``mamba2_mix`` (the same chunked SSD, its
einsums split in two) and ``mamba_block`` from scratch and from a state,
at a prefill length and at S = 1: outputs and states within atol = rtol
= 1e-4 (float32, sums in another order).  The parameter trees agree in
names, shapes and dtypes, at bfloat16 too (``D``, ``dt_bias`` and
``A_log`` stay float32), and in the values ``ssm_init`` does not draw.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.configs.base import SSMConfig
from repro_torch.models import ssm as TS

from conftest import tiny

TOL = dict(atol=1e-4, rtol=1e-4)
B, S = 2, 24


def dims_of(arch: str):
    cfg = tiny(arch)
    return JS.ssm_dims(cfg.ssm, cfg.d_model), cfg


@pytest.fixture(scope="module", params=["falcon-mamba-7b", "zamba2-1.2b"])
def block(request):
    """(reference dims, port dims, numpy params, rng) for one version."""
    jdims, cfg = dims_of(request.param)
    tdims = TS.ssm_dims(SSMConfig(**vars(cfg.ssm)), cfg.d_model)
    params = jax.tree.map(np.asarray, JS.ssm_init(jax.random.PRNGKey(1),
                                                  jdims, jnp.float32))
    rng = np.random.default_rng(3)
    for key in ("dt_bias", "D", "conv_b"):
        params[key] = (params[key] + rng.normal(0.0, 0.3, params[key].shape)
                       ).astype(np.float32)
    return jdims, tdims, params, rng


def jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def th(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def close(got, want, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                               err_msg=what)


def test_dims_match(block):
    jdims, tdims, _, _ = block
    assert vars(jdims) == vars(tdims)
    for s in range(1, 70):
        assert TS._n_chunks(s, tdims) == JS._n_chunks(s, jdims)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("length", [S, 1, 2])
def test_causal_conv(block, with_state, length):
    _, tdims, params, rng = block
    x = rng.standard_normal((B, length, tdims.d_inner)).astype(np.float32)
    st = (rng.standard_normal((B, tdims.d_conv - 1, tdims.d_inner))
          .astype(np.float32) if with_state else None)
    p = th(params)
    y, new = TS.causal_conv(torch.from_numpy(x), p["conv_w"], p["conv_b"],
                            None if st is None else torch.from_numpy(st))
    jy, jnew = JS.causal_conv(jnp.asarray(x), jnp.asarray(params["conv_w"]),
                              jnp.asarray(params["conv_b"]),
                              None if st is None else jnp.asarray(st))
    close(y, jy, "y")
    close(new, jnew, "state")


def _mix_inputs(tdims, params, rng, length, with_state):
    x_conv = rng.standard_normal((B, length, tdims.d_inner)).astype(np.float32)
    if tdims.version == 1:
        shape = (B, tdims.d_inner, tdims.d_state)
    else:
        shape = (B, tdims.n_heads, tdims.head_dim, tdims.d_state)
    h0 = rng.standard_normal(shape).astype(np.float32) if with_state else None
    return x_conv, h0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("length", [S, 1])
def test_mix(block, with_state, length):
    jdims, tdims, params, rng = block
    x_conv, h0 = _mix_inputs(tdims, params, rng, length, with_state)
    th0 = None if h0 is None else torch.from_numpy(h0)
    jh0 = None if h0 is None else jnp.asarray(h0)
    if tdims.version == 1:
        y, h = TS.mamba1_mix(th(params), torch.from_numpy(x_conv), tdims, th0)
        jy, jh = JS.mamba1_mix(jx(params), jnp.asarray(x_conv), jdims, jh0)
    else:
        xin = rng.standard_normal((B, length, tdims.d_model)).astype(
            np.float32)
        dt = np.logaddexp(0.0, xin @ params["w_dt_head"] + params["dt_bias"])
        bc = (xin @ params["w_bc"]).astype(np.float32)
        bt, ct = np.split(bc, 2, axis=-1)
        dt = dt.astype(np.float32)
        y, h = TS.mamba2_mix(th(params), torch.from_numpy(x_conv), tdims, th0,
                             dt_pre=torch.from_numpy(dt),
                             bc_pre=(torch.from_numpy(bt.copy()),
                                     torch.from_numpy(ct.copy())))
        jy, jh = JS.mamba2_mix(jx(params), jnp.asarray(x_conv), jdims, jh0,
                               dt_pre=jnp.asarray(dt),
                               bc_pre=(jnp.asarray(bt), jnp.asarray(ct)))
    close(y, jy, "y")
    close(h, jh, "h_last")


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("length", [S, 1])
def test_mamba_block(block, with_state, length):
    jdims, tdims, params, rng = block
    x = rng.standard_normal((B, length, tdims.d_model)).astype(np.float32)
    state = None
    if with_state:
        _, h0 = _mix_inputs(tdims, params, rng, length, True)
        conv = rng.standard_normal((B, tdims.d_conv - 1, tdims.d_inner))
        state = {"conv": conv.astype(np.float32), "ssm": h0}
    y, new = TS.mamba_block(th(params), torch.from_numpy(x), tdims,
                            None if state is None else th(state))
    jy, jnew = JS.mamba_block(jx(params), jnp.asarray(x), jdims,
                              None if state is None else jx(state))
    close(y, jy, "y")
    assert new.keys() == jnew.keys()
    for key in new:
        close(new[key], jnew[key], key)


@pytest.mark.parametrize("length", [S, 1])
def test_mamba_block_in_place(block, length):
    """A decode step's form: the new states overwrite the given state's
    tensors (B4 writes the Mamba-1 state there itself), which come back
    as the new state, equal to the reference's."""
    jdims, tdims, params, rng = block
    x = rng.standard_normal((B, length, tdims.d_model)).astype(np.float32)
    _, h0 = _mix_inputs(tdims, params, rng, length, True)
    conv = rng.standard_normal((B, tdims.d_conv - 1, tdims.d_inner))
    state = {"conv": conv.astype(np.float32), "ssm": h0}
    given = th(state)
    y, new = TS.mamba_block(th(params), torch.from_numpy(x), tdims, given,
                            in_place=True)
    jy, jnew = JS.mamba_block(jx(params), jnp.asarray(x), jdims, jx(state))
    close(y, jy, "y")
    assert new is given
    for key in jnew:
        close(given[key], jnew[key], key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parameter_trees_match(block, dtype):
    jdims, tdims, _, _ = block
    jdt = getattr(jnp, dtype)
    want = jax.eval_shape(lambda k: JS.ssm_init(k, jdims, jdt),
                          jax.random.PRNGKey(0))
    mod = TS.Mamba(tdims, getattr(torch, dtype), "meta", None)
    got = dict(mod.named_parameters())
    assert got.keys() == want.keys()
    for key, leaf in want.items():
        assert tuple(got[key].shape) == leaf.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(leaf.dtype), key


def test_initial_values_match_where_nothing_is_drawn(block):
    jdims, tdims, _, _ = block
    want = JS.ssm_init(jax.random.PRNGKey(0), jdims, jnp.float32)
    mod = TS.Mamba(tdims, torch.float32, "cpu", torch.Generator())
    for key in ("conv_b", "D", "dt_bias", "A_log"):
        np.testing.assert_allclose(getattr(mod, key).detach().numpy(),
                                   np.asarray(want[key]), rtol=1e-6,
                                   err_msg=key)
    w = mod.conv_w.detach()
    assert abs(float(w.std()) - 0.2) < 0.05        # drawn at 0.2


def test_state_specs_match(block):
    jdims, tdims, _, _ = block
    want = JS.ssm_state_specs(jdims, 3, jnp.bfloat16)
    got = TS.ssm_state_specs(tdims, 3, torch.bfloat16)
    assert got.keys() == want.keys()
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
