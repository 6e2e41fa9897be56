"""Whisper's pieces in the port against the JAX package's, on the CPU.

``sinusoid_embed`` (positions of whisper's decoder, 0 to its
``max_position`` of 448, in several shapes) and ``sinusoid_positions``
(the encoder's table at 1,500 frames and at the tiny width) against
``repro.models.layers``, at atol = rtol = 1e-5 plus what a position
makes of one ulp of a timescale: XLA's float32 ``exp`` is off by one ulp
at 32 of whisper's 384 timescales where torch's is correctly rounded at
all but 4, and the angle ``pos * inv`` carries that error times the
position, so each element gets ``2 * angle * 2**-23`` more (at most
3.6e-4 at position 1,499; below 1e-6 at the positions of the model
tests); the timescales themselves agree within one ulp.
``cross_attention`` (decoder queries over an encoder context of another
length, MHA and GQA) against
``repro.models.attention``; and ``Model._encode`` (frames plus positions
through the encoder's bidirectional layers and ``enc_norm``) against
``repro.models.model._encode`` at the conftest ``tiny`` whisper size, with
the reference's weights carried by ``params_from_reference``.  Float32,
inputs from numpy seeds, atol = rtol = 1e-5.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.convert import params_from_reference

from conftest import tiny
from test_torch_models import perturb, port_config

TOL = dict(atol=1e-5, rtol=1e-5)


def assert_within_angle_tol(got, want, pos, d: int) -> None:
    """|got - want| <= 1e-5 + 1e-5 |want| + two ulps of the angle
    pos * inv (one from a timescale's ulp times the position, one from
    the product's rounding), element by element."""
    half = d // 2
    inv = np.exp(-np.log(10_000.0) / max(half - 1, 1) * np.arange(half))
    angle = np.asarray(pos, np.float64)[..., None] * inv
    tol = 1e-5 + 1e-5 * np.abs(want) + 2 * np.concatenate(
        [angle, angle], -1) * 2.0 ** -23
    excess = np.abs(got - want) - tol
    assert excess.max(initial=-1.0) <= 0, f"worst excess {excess.max():.3g}"


@pytest.mark.parametrize("d", [64, 768])
@pytest.mark.parametrize("shape", [(448,), (2, 3), ()])
def test_sinusoid_embed_matches(d, shape):
    pos = np.random.default_rng(d).integers(0, 448, shape).astype(np.int32)
    if shape == (448,):
        pos = np.arange(448, dtype=np.int32)
    want = np.asarray(JL.sinusoid_embed(jnp.asarray(pos), d))
    got = TL.sinusoid_embed(torch.from_numpy(pos), d)
    assert got.dtype == torch.float32 and got.shape == (*shape, d)
    assert_within_angle_tol(got.numpy(), want, pos, d)


@pytest.mark.parametrize("d", [64, 768])
def test_sinusoid_timescales_within_an_ulp(d):
    """The timescales, which position 1's angles are, agree within one
    ulp; at position 1 the embedding agrees at 1e-5 with no slack."""
    half = d // 2
    lt = np.log(10_000.0) / max(half - 1, 1)
    want = np.asarray(jnp.exp(-lt * jnp.arange(half, dtype=jnp.float32)))
    got = torch.exp(-lt * torch.arange(half, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=0)
    one = np.ones((), np.int32)
    np.testing.assert_allclose(
        TL.sinusoid_embed(torch.from_numpy(one), d).numpy(),
        np.asarray(JL.sinusoid_embed(jnp.asarray(one), d)), **TOL)


@pytest.mark.parametrize("n,d", [(1500, 768), (12, 64)])
def test_sinusoid_positions_match(n, d):
    assert_within_angle_tol(TL.sinusoid_positions(n, d).numpy(),
                            np.asarray(JL.sinusoid_positions(n, d)),
                            np.arange(n), d)


@pytest.mark.parametrize("S,T,H,KV", [(5, 12, 4, 4), (12, 12, 4, 4),
                                      (7, 30, 6, 2), (1, 16, 4, 1)])
def test_cross_attention_matches(S, T, H, KV):
    rng = np.random.default_rng(S * T + H)
    q = rng.standard_normal((2, S, H, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, T, KV, 16)).astype(np.float32)
            for _ in range(2))
    jl = JA.head_layout(H, KV, 16, 1)
    want = JA.cross_attention(*map(jnp.asarray, (q, k, v)), jl)
    got = TA.cross_attention(*map(torch.from_numpy, (q, k, v)),
                             TA.head_layout(H, KV, 16))
    assert got.shape == (2, S, H, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_matches():
    jcfg = tiny("whisper-small")
    tree = perturb(jax.tree.map(np.asarray, JM.init_params(
        jax.random.PRNGKey(3), jcfg)), np.random.default_rng(3))
    model = params_from_reference(tree, port_config(jcfg), "cpu")
    frames = np.random.default_rng(5).standard_normal(
        (2, jcfg.encdec.n_encoder_ctx, jcfg.d_model)).astype(np.float32)
    want = JM._encode(jax.tree.map(jnp.asarray, tree), jcfg,
                      jnp.asarray(frames), JM._layout(jcfg))
    with torch.no_grad():
        got = model._encode(torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_whisper_plan_and_cache():
    """The encoder stage (bidirectional, rope-free) before the decoder
    stage (causal, rope-free, cross-attention), the encoder outside the
    cache, and the cross K/V in each decoder entry at the encoder's
    context."""
    from repro_torch.models import model as TM
    cfg = port_config(tiny("whisper-small"))
    plan = TM.build_plan(cfg)
    assert [(s.name, s.encoder, s.n_periods) for s in plan] == [
        ("encoder", True, 2), ("decoder", False, 2)]
    enc, dec = plan[0].specs[0], plan[1].specs[0]
    assert (enc.causal, enc.cross, enc.use_rope) == (False, False, False)
    assert (dec.causal, dec.cross, dec.use_rope) == (True, True, False)
    specs = TM.cache_specs(cfg, 3, 20)
    assert list(specs) == ["decoder"]
    entry = specs["decoder"]["layer0"]
    assert tuple(entry["xk"].shape) == (2, 3, 12, 4, 16)
    assert tuple(entry["k"].shape) == (2, 3, 20, 4, 16)
    model = TM.Model(cfg, generator=torch.Generator().manual_seed(0),
                     device="cpu")
    with pytest.raises(ValueError, match="frames"):
        model.prefill(torch.zeros((1, 4), dtype=torch.int32))
