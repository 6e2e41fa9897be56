"""The port's Mixture-of-Experts (``repro_torch.models.moe``) against
``repro.models.moe``, on the CPU.

At the conftest ``tiny`` moe width (d_model 64, 8 experts top-2, d_ff 32),
float32, with the reference's ``moe_init`` weights carried as numpy and
inputs from numpy seeds, each piece is held against the reference's on
the same inputs at atol = rtol = 1e-5 (float32, sums in another order):
``_route`` (gates, expert indices, aux loss), ``_capacity``, ``_bucket``
(the buckets' inputs, gates and token slots: equal), ``_combine``,
``_moe_local`` and ``moe_apply``.  The cases cross a capacity factor of
1.25 with 0.25, at which buckets overflow and assignments are dropped
(the test checks that some are), and an expert-parallel degree of 1 with
3, at which 8 experts pad to 9 and the padded one must never be chosen.
A moe layer with shared experts (qwen2-moe's, behind their sigmoid gate)
is held against the reference's ``_attn_layer_full`` at 1e-5 with
overflowing buckets.  The combine, which sums without atomics, must give
bitwise-equal outputs on two calls; its card-only twin is in
tests/test_torch_moe_cuda.py.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch.configs.base import MoEConfig
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE

from conftest import tiny

TOL = dict(atol=1e-5, rtol=1e-5)
N = 40                          # tokens: 80 assignments over 8 or 9 experts
CASES = [(cf, ep) for cf in (1.25, 0.25) for ep in (1, 3)]


def configs(cf: float):
    base = tiny("granite-moe-3b-a800m").moe
    jcfg = dataclasses.replace(base, capacity_factor=cf)
    return jcfg, MoEConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", params=CASES,
                ids=[f"cf{cf}-ep{ep}" for cf, ep in CASES])
def case(request):
    """Reference and port dims, numpy weights and inputs for one case."""
    cf, ep = request.param
    jcfg, tcfg = configs(cf)
    d = 64
    jdims = JMoE.moe_dims(jcfg, d, ep)
    tdims = TMoE.moe_dims(tcfg, d, ep)
    params = jax.tree.map(np.asarray, JMoE.moe_init(
        jax.random.PRNGKey(ep), jdims, jnp.float32))
    x = np.random.default_rng(int(cf * 100) + ep).standard_normal(
        (N, d)).astype(np.float32)
    return jdims, tdims, params, x


def th(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_dims_match(case):
    """Field by field; the port's own ``renormalize`` at the JAX package's
    behaviour, renormalised gates."""
    jdims, tdims, _, _ = case
    got = dataclasses.asdict(tdims)
    assert got.pop("renormalize") is True
    assert got == dataclasses.asdict(jdims)


def test_router_is_float32_in_a_bf16_layer():
    dims = TMoE.moe_dims(configs(1.25)[1], 64)
    layer = TMoE.MoE(dims, torch.bfloat16, "cpu",
                     torch.Generator().manual_seed(0))
    assert layer.router.dtype == torch.float32
    assert {p.dtype for n, p in layer.named_parameters()
            if n != "router"} == {torch.bfloat16}
    jtree = JMoE.moe_init(jax.random.PRNGKey(0), JMoE.moe_dims(
        configs(1.25)[0], 64, 1), jnp.bfloat16)
    assert {k: tuple(v.shape) for k, v in jtree.items()} == {
        n: tuple(p.shape) for n, p in layer.named_parameters()}


def test_route_matches(case):
    jdims, tdims, params, x = case
    jg, ji, ja = JMoE._route(jnp.asarray(params["router"]), jnp.asarray(x),
                             jdims)
    tg, ti, ta = TMoE._route(torch.from_numpy(np.array(params["router"])),
                             torch.from_numpy(x), tdims)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    assert int(ti.max()) < jdims.n_experts      # padded experts never chosen


@pytest.mark.parametrize("n_tokens", [1, 8, 40, 4096])
@pytest.mark.parametrize("cf,ep", CASES)
def test_capacity_matches(n_tokens, cf, ep):
    jcfg, tcfg = configs(cf)
    assert TMoE._capacity(n_tokens, TMoE.moe_dims(tcfg, 64, ep)) == \
        JMoE._capacity(n_tokens, JMoE.moe_dims(jcfg, 64, ep))


def test_bucket_matches_and_drops(case):
    jdims, tdims, params, x = case
    jg, ji, _ = JMoE._route(jnp.asarray(params["router"]), jnp.asarray(x),
                            jdims)
    C = JMoE._capacity(N, jdims)
    jxe, jge, jtok = JMoE._bucket(jnp.asarray(x), jg, ji, C, jdims)
    txe, tge, ttok = TMoE._bucket(torch.from_numpy(x),
                                  torch.from_numpy(np.asarray(jg)),
                                  torch.from_numpy(np.asarray(ji)).long(), C,
                                  tdims)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tge.numpy(), np.asarray(jge))
    np.testing.assert_array_equal(txe.numpy(), np.asarray(jxe))
    kept = int((ttok < N).sum())
    if jdims.capacity_factor < 1:
        assert kept < N * jdims.top_k           # buckets overflowed
    else:
        assert kept == N * jdims.top_k


def test_combine_matches_and_repeats_bitwise(case):
    jdims, tdims, params, x = case
    jg, ji, _ = JMoE._route(jnp.asarray(params["router"]), jnp.asarray(x),
                            jdims)
    C = JMoE._capacity(N, jdims)
    _, jge, jtok = JMoE._bucket(jnp.asarray(x), jg, ji, C, jdims)
    y_e = np.random.default_rng(9).standard_normal(
        (jdims.e_pad, C, 64)).astype(np.float32)
    want = JMoE._combine(jnp.asarray(y_e), jge, jtok, N, 64)
    args = (torch.from_numpy(y_e), torch.from_numpy(np.asarray(jge)),
            torch.from_numpy(np.asarray(jtok)).long(), N, 64, tdims.top_k)
    got = TMoE._combine(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(got, TMoE._combine(*args))


def test_moe_local_and_apply_match(case):
    jdims, tdims, params, x = case
    jy, ja = JMoE._moe_local(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(x), jdims)
    ty, ta = TMoE._moe_local(th(params), torch.from_numpy(x), tdims)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    x3 = x.reshape(4, N // 4, 64)
    jy, ja = JMoE.moe_apply(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(x3), jdims)
    ty, ta = TMoE.moe_apply(th(params), torch.from_numpy(x3), tdims)
    assert ty.shape == (4, N // 4, 64)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)


def test_moe_module_matches_moe_apply(case):
    _, tdims, params, x = case
    layer = TMoE.MoE(tdims, torch.float32, "meta", None).to_empty(
        device="cpu")
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(torch.from_numpy(np.array(params[name])))
    x3 = torch.from_numpy(x).reshape(2, N // 2, 64)
    y, aux = layer(x3)
    want, want_aux = TMoE.moe_apply(th(params), x3, tdims)
    assert torch.equal(y, want) and torch.equal(aux, want_aux)


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_layer_with_shared_experts_matches(cf):
    """qwen2-moe's layer (routed experts, then the shared experts behind
    their float32 sigmoid gate) against the reference's
    ``_attn_layer_full``, with buckets that overflow at cf 0.25."""
    from test_torch_models import perturb, port_config
    jcfg = tiny("qwen2-moe-a2.7b")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    assert jcfg.moe.n_shared_experts
    rng = np.random.default_rng(4)
    tree = perturb(jax.tree.map(np.asarray, JM.init_params(
        jax.random.PRNGKey(2), jcfg)), rng)
    from repro_torch.models.convert import params_from_reference
    model = params_from_reference(tree, port_config(jcfg), "cpu")
    stage = JM.build_plan(jcfg)[0]
    spec = stage.specs[0]
    layer = model.stages[stage.name][0]["layer0"]
    assert hasattr(layer, "shared_mlp") and hasattr(layer, "shared_gate")
    x = rng.standard_normal((2, 20, jcfg.d_model)).astype(np.float32)
    p0 = jax.tree.map(lambda a: jnp.asarray(a[0]), tree[stage.name]["layer0"])
    want, _, want_aux = JM._attn_layer_full(p0, jnp.asarray(x), spec, jcfg,
                                            JM._layout(jcfg), {},
                                            want_cache=False)
    rot = model._rotations(torch.arange(20), {})
    tspec = TM.build_plan(port_config(jcfg))[0].specs[0]
    with torch.no_grad():
        got, _, aux = layer.full(torch.from_numpy(x), rot[tspec],
                                 want_cache=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), **TOL)
