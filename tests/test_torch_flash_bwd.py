"""The backward pass of flash attention (B3) on the CPU: its plain
version against ``jax.vjp`` of ``repro.kernels.ref.flash_attention_ref``
and against ``torch.autograd`` of the plain forward, and
``FlashAttentionFn`` as the model reaches it.

The JAX package has no backward kernel; its gradient is ``jax.vjp`` of its
jnp oracle, which is what ``flash_attention_bwd_reference`` (the formulas
of the port's backward kernels, ``csrc/flash_attention_bwd.cu``) is held
to here, float32, on tests/test_kernels.py's shapes and masks (through
tests/test_torch_attention_cuda.py's ``flash_cases``), with the forward's
output and log-sum-exp from the plain version.  The log-sum-exp itself is
held to float64 numpy.  Tolerance atol = rtol = 1e-4: float32 sums in
another order (``BWD_TOL``).  On the CPU ``FlashAttentionFn`` runs the
plain versions forward and backward, so it is exercised here too.
``bwd_route``, which picks the backward kernels on the card, is checked
for every dtype and head dim, and no CPU call counts a launch:
through ``ops.flash_attention`` with the model's [B, S, H, D] views, its
gradients must equal autograd's of the plain forward within float32
rounding and come back in the views' shapes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    DTYPES,
    HEAD_DIMS,
    FlashAttentionFn,
    bwd_route,
    flash_attention_bhsd,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_lse_reference,
    flash_attention_reference,
)
from test_torch_attention_cuda import flash_cases, model_flash

BWD_TOL = dict(atol=1e-4, rtol=1e-4)
CASES = flash_cases()


def _lse_numpy(q, k, causal, window):
    BH, S, D = q.shape
    r = BH // k.shape[0]
    kx = np.repeat(k.astype(np.float64), r, axis=0)
    s = np.einsum("hqd,hkd->hqk", q.astype(np.float64), kx) / np.sqrt(D)
    qpos, kpos = np.arange(S)[:, None], np.arange(S)[None, :]
    mask = np.ones((S, S), bool)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= kpos > qpos - window
    s = np.where(mask[None], s, -1e30)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("name,case", CASES, ids=[n for n, _ in CASES])
def test_plain_backward_matches_jax_vjp(name, case):
    q, k, v = (case[n] for n in "qkv")
    kw = dict(causal=case["causal"], window=case["window"])
    do = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: ref.flash_attention_ref(a, b, c, **kw),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = flash_attention_bhsd(tq, tk, tv, with_lse=True, **kw)
    np.testing.assert_allclose(lse.numpy(), _lse_numpy(q, k, **kw),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        lse.numpy(), flash_attention_lse_reference(tq, tk, **kw).numpy(),
        rtol=0, atol=0)
    got = flash_attention_bwd(tq, tk, tv, o, lse, tdo, **kw)
    for n, g, w in zip("qkv", got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, **BWD_TOL, err_msg=f"d{n}")


@pytest.mark.parametrize("name,case", CASES[::3], ids=[n for n, _ in CASES[::3]])
def test_plain_backward_matches_torch_autograd(name, case):
    kw = dict(causal=case["causal"], window=case["window"])
    leaves = [torch.from_numpy(case[n]).requires_grad_() for n in "qkv"]
    do = torch.from_numpy(np.random.default_rng(8).standard_normal(
        case["q"].shape).astype(np.float32))
    o = flash_attention_reference(*leaves, **kw)
    want = torch.autograd.grad(o, leaves, do)
    lse = flash_attention_lse_reference(leaves[0], leaves[1], **kw)
    got = flash_attention_bwd_reference(*(t.detach() for t in leaves),
                                        o.detach(), lse, do, kw["causal"],
                                        kw["window"])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **BWD_TOL)


@pytest.mark.parametrize("window", (None, 16))
def test_function_through_ops_in_the_model_layout(window):
    """``ops.flash_attention`` with inputs that require a gradient takes
    ``FlashAttentionFn``; on [B, H, S, D] views of [B, S, H, D]
    activations (GQA 14/2) its gradients equal autograd's of the plain
    forward and come back in the activations' shapes."""
    c = model_flash("cpu", torch.float32, B=2, S=40, H=14, KV=2,
                    window=window)
    base = [c[n].transpose(1, 2).contiguous().requires_grad_()
            for n in "qkv"]                             # [B, S, heads, D]
    views = [t.transpose(1, 2) for t in base]
    o = ops.flash_attention(*views, causal=True, window=window)
    assert "FlashAttentionFn" in type(o.grad_fn).__name__
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad(o, base, do)
    base2 = [t.detach().clone().requires_grad_() for t in base]
    o2 = flash_attention_reference(*(t.transpose(1, 2) for t in base2),
                                   causal=True, window=window)
    torch.testing.assert_close(o, o2, atol=0, rtol=0)
    want = torch.autograd.grad(o2, base2, do)
    for g, w, t in zip(got, want, base):
        assert g.shape == t.shape
        torch.testing.assert_close(g, w, atol=2e-6, rtol=1e-5)


def test_no_function_without_a_gradient():
    c = model_flash("cpu", torch.float32, B=1, S=8, H=4, KV=2)
    o = ops.flash_attention(c["q"], c["k"], c["v"])
    assert o.grad_fn is None
    q = c["q"].clone().requires_grad_()
    with torch.no_grad():
        assert ops.flash_attention(q, c["k"], c["v"]).grad_fn is None
    assert FlashAttentionFn.apply(q, c["k"], c["v"], True, None).grad_fn \
        is not None


@pytest.mark.parametrize("dtype", sorted(DTYPES, key=str))
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_bwd_route(dtype, D):
    """bf16 at D 64 and 128 on the tensor cores, the rest on the CUDA
    cores: D 256's dK and dV accumulators do not fit a thread's
    registers."""
    want = "wgmma" if dtype == torch.bfloat16 and D in (64, 128) else "simt"
    assert bwd_route(dtype, D) == want


def test_cpu_backward_counts_no_launch():
    c = model_flash("cpu", torch.float32, B=1, S=8, H=4, KV=2)
    o, lse = flash_attention_bhsd(c["q"], c["k"], c["v"], with_lse=True)
    before = (flash_attention_bwd.launches,
              dict(flash_attention_bwd.launches_by_route))
    flash_attention_bwd(c["q"], c["k"], c["v"], o, lse, torch.ones_like(o))
    assert before == (flash_attention_bwd.launches,
                      flash_attention_bwd.launches_by_route)
    assert sorted(before[1]) == ["simt", "wgmma"]
