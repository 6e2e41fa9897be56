"""The backward pass of the Mamba-1 selective scan (B4) on the CPU: its
plain version against ``jax.vjp`` of ``repro.kernels.ref.mamba1_scan_ref``
and against ``torch.autograd`` of the plain forward, and ``MambaScanFn``
as the model reaches it.

The JAX package has no backward kernel; its gradient is ``jax.vjp`` of its
sequential oracle, which starts from zero and returns y only, so
``mamba1_scan_bwd_reference`` (the recurrence the port's backward kernel
computes, ``csrc/mamba_scan_bwd.cu``) is held to it with no initial state
and no final-state gradient, on tests/test_kernels.py's shapes and the
other cases of tests/test_torch_mamba_scan_cuda.py's ``SHAPES``; with an
initial state and a final-state gradient it is held to autograd of
``mamba1_scan_reference``.  Tolerance ``TOL`` (atol = rtol = 1e-4,
tests/test_kernels.py's for this kernel), the atol scaled by each
gradient's largest magnitude: dB, dC and dA are sums over channels or
steps.  ``MambaScanFn`` runs the plain versions forward and backward on
the CPU; ``ops.mamba_scan`` takes it when a gradient is required and then
refuses an ``h_out``.  The checkpoints the forward pass keeps for the
backward pass (``with_checkpoints``, the state before steps 0, 16, 32, ...)
are held to a step-by-step numpy recurrence in float64 at ``TOL``, and
``MambaScanFn`` is shown to keep them for its backward pass.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import ops
from repro_torch.kernels.mamba_scan import (
    CKPT_STEPS,
    MambaScanFn,
    mamba1_scan,
    mamba1_scan_bwd,
    mamba1_scan_bwd_reference,
    mamba1_scan_reference,
    n_checkpoints,
)
from test_torch_mamba_scan_cuda import SHAPES, TOL, scan_case, shape_id

NAMES = ("x", "dt", "Bt", "Ct", "A")


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                               atol=TOL["atol"] * scale, err_msg=what)


@pytest.mark.parametrize("shape", SHAPES, ids=[shape_id(s) for s in SHAPES])
def test_plain_backward_matches_jax_vjp(shape):
    c = scan_case(*shape)
    dy = np.random.default_rng(4).standard_normal(
        c["x"].shape).astype(np.float32)
    _, vjp = jax.vjp(ref.mamba1_scan_ref, *(jnp.asarray(c[n]) for n in NAMES))
    want = vjp(jnp.asarray(dy))
    got = mamba1_scan_bwd(*(torch.from_numpy(c[n]) for n in NAMES), None,
                          torch.from_numpy(dy), None)
    for n, g, w in zip(NAMES, got, want):
        _close(g.numpy(), np.asarray(w), f"d{n}")


@pytest.mark.parametrize("shape", SHAPES[4:], ids=[shape_id(s)
                                                   for s in SHAPES[4:]])
def test_plain_backward_with_states_matches_torch_autograd(shape):
    c = scan_case(*shape)
    rng = np.random.default_rng(5)
    dy = torch.from_numpy(rng.standard_normal(c["x"].shape).astype(
        np.float32))
    dh = torch.from_numpy(rng.standard_normal(c["h0"].shape).astype(
        np.float32))
    leaves = [torch.from_numpy(c[n]).requires_grad_()
              for n in NAMES + ("h0",)]
    want = torch.autograd.grad(mamba1_scan_reference(*leaves), leaves,
                               (dy, dh))
    got = mamba1_scan_bwd_reference(*(t.detach() for t in leaves), dy, dh)
    for n, g, w in zip(NAMES + ("h0",), got, want):
        _close(g.numpy(), w.numpy(), f"d{n}")


def test_function_through_ops_as_the_model_calls_it():
    """B_t and C_t as slices of one projection, no initial state: the
    gradients ``ops.mamba_scan`` gives through ``MambaScanFn`` equal
    autograd's of the plain forward."""
    c = scan_case(2, 24, 64, 16, False)
    g = torch.Generator().manual_seed(0)
    xbc = torch.randn(2, 24, 5 + 32, generator=g).requires_grad_()
    x, dt, A = (torch.from_numpy(c[n]).requires_grad_()
                for n in ("x", "dt", "A"))
    y, h = ops.mamba_scan(x, dt, xbc[..., 5:21], xbc[..., 21:], A)
    assert "MambaScanFn" in type(y.grad_fn).__name__
    dy = torch.randn(y.shape, generator=g)
    got = torch.autograd.grad(y, (x, dt, xbc, A), dy)
    y2, _ = mamba1_scan_reference(x, dt, xbc[..., 5:21], xbc[..., 21:], A)
    torch.testing.assert_close(y, y2, atol=0, rtol=0)
    want = torch.autograd.grad(y2, (x, dt, xbc, A), dy)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a.numpy(), b.numpy(), "grad")


def test_function_returns_h0s_gradient_and_refuses_h_out():
    c = scan_case(1, 9, 32, 8, True)
    t = {n: torch.from_numpy(c[n]).requires_grad_() for n in c}
    y, h = MambaScanFn.apply(*(t[n] for n in NAMES + ("h0",)))
    (dh0,) = torch.autograd.grad((y.sum() + h.sum()), (t["h0"],))
    assert dh0.shape == t["h0"].shape and torch.isfinite(dh0).all()
    with pytest.raises(ValueError, match="in place"):
        ops.mamba_scan(*(t[n] for n in NAMES), t["h0"],
                       h_out=torch.empty_like(t["h0"]))
    with torch.no_grad():      # decode: no gradient, h_out taken
        out = torch.empty_like(t["h0"])
        assert ops.mamba_scan(*(t[n] for n in NAMES), t["h0"],
                              h_out=out)[1] is out


def _numpy_checkpoints(c) -> np.ndarray:
    """The state before steps 0, 16, 32, ..., step by step in float64."""
    x, dt, Bt, A = (c[n].astype(np.float64) for n in ("x", "dt", "Bt", "A"))
    B, T, Di = x.shape
    h = (np.zeros((B, Di, A.shape[1])) if c["h0"] is None
         else c["h0"].astype(np.float64))
    out = []
    for t in range(T):
        if t % CKPT_STEPS == 0:
            out.append(h)
        h = (np.exp(dt[:, t, :, None] * A[None]) * h
             + (dt[:, t] * x[:, t])[:, :, None] * Bt[:, t, None, :])
    return np.stack(out, 1)


CKPT_SHAPES = [(2, 1, 64, 16, True), (1, 15, 32, 8, False),
               (2, 17, 48, 32, True), (1, 40, 24, 64, True),
               (2, 64, 32, 16, False)]


@pytest.mark.parametrize("shape", CKPT_SHAPES,
                         ids=[shape_id(s) for s in CKPT_SHAPES])
def test_plain_checkpoints_match_a_numpy_recurrence(shape):
    c = scan_case(*shape)
    t = {n: None if v is None else torch.from_numpy(v) for n, v in c.items()}
    args = [t[n] for n in NAMES + ("h0",)]
    y, h, ckpt = mamba1_scan(*args, with_checkpoints=True)
    assert ckpt.shape == (shape[0], n_checkpoints(shape[1]), shape[2],
                          shape[3])
    assert ckpt.dtype == torch.float32
    _close(ckpt.numpy(), _numpy_checkpoints(c), "checkpoints")
    y0, h0 = mamba1_scan(*args)
    assert torch.equal(y, y0) and torch.equal(h, h0)


@pytest.mark.parametrize("shape", CKPT_SHAPES,
                         ids=[shape_id(s) for s in CKPT_SHAPES])
def test_function_keeps_the_checkpoints_for_its_backward(shape):
    """``MambaScanFn`` asks its forward pass for checkpoints and hands
    them to the backward pass: its saved tensors hold them, and its
    gradients equal autograd's of the plain forward."""
    c = scan_case(*shape)
    t = {n: None if v is None else torch.from_numpy(v).requires_grad_()
         for n, v in c.items()}
    args = [t[n] for n in NAMES + ("h0",)]
    y, h = MambaScanFn.apply(*args)
    saved = y.grad_fn.saved_tensors
    assert saved[-1].shape == (shape[0], n_checkpoints(shape[1]), shape[2],
                               shape[3])
    torch.testing.assert_close(saved[-1], torch.from_numpy(
        _numpy_checkpoints(c)).float(), rtol=1e-4, atol=1e-4)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    got = torch.autograd.grad(y, [a for a in args if a is not None], dy)
    args2 = [None if a is None else a.detach().clone().requires_grad_()
             for a in args]
    want = torch.autograd.grad(mamba1_scan_reference(*args2)[0],
                               [a for a in args2 if a is not None], dy)
    for a, b in zip(got, want):
        _close(a.numpy(), b.numpy(), "grad")
