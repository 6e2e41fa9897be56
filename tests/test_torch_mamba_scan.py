"""The port of the Mamba-1 selective scan (B4) against the JAX package, on
the CPU.

The plain PyTorch version (what the port's wrapper computes for CPU
tensors, and what the CUDA kernel is held against on the card) must agree
with ``repro``'s Pallas kernel in interpret mode and with
``repro.kernels.ref.mamba1_scan_ref`` on the cases of
tests/test_torch_mamba_scan_cuda.py that start from zero, at atol = rtol =
1e-4 (tests/test_kernels.py's tolerance for this kernel).  The state the
port adds is checked two ways: a scan split in two, the second half
starting from the first half's ``h_last``, equals the whole scan (1e-5:
the same operations in the same order, so only the split's own rounding
differs), and ``h_last`` equals the final state of
``repro.models.ssm.mamba1_mix`` (its chunked associative scan sums in
another order: 1e-4).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig
from repro.kernels import ref
from repro.kernels.mamba_scan import mamba1_scan as jax_scan
from repro.models import ssm as JS
from repro_torch.kernels import ops
from repro_torch.kernels.mamba_scan import (
    _check,
    mamba1_scan,
    mamba1_scan_reference,
)
from test_torch_mamba_scan_cuda import (
    SHAPES,
    TOL,
    run,
    scan_case,
    shape_id,
    to_torch,
)

FROM_ZERO = [s for s in SHAPES if not s[-1]]


@pytest.mark.parametrize("shape", FROM_ZERO,
                         ids=[shape_id(s) for s in FROM_ZERO])
def test_plain_version_matches_the_jax_package(shape):
    case = scan_case(*shape)
    args = [jnp.asarray(case[k]) for k in ("x", "dt", "Bt", "Ct", "A")]
    y, h = run(mamba1_scan, to_torch(case, "cpu"))
    assert y.shape == case["x"].shape
    assert h.shape == (shape[0], shape[2], shape[3])
    np.testing.assert_allclose(
        y.numpy(), np.asarray(ref.mamba1_scan_ref(*args)), **TOL)
    Di = shape[2]
    blk = 128 if Di % 128 == 0 else Di
    np.testing.assert_allclose(
        y.numpy(), np.asarray(jax_scan(*args, blk_d=blk, interpret=True)),
        **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=[shape_id(s) for s in SHAPES])
def test_state_carries_across_a_split(shape):
    c = to_torch(scan_case(*shape), "cpu")
    y, h = run(mamba1_scan_reference, c)
    T = shape[1]
    cut = T // 2 + 1
    first = {k: (v[:, :cut] if k in ("x", "dt", "Bt", "Ct") else v)
             for k, v in c.items()}
    y1, h1 = run(mamba1_scan_reference, first)
    rest = {k: (v[:, cut:] if k in ("x", "dt", "Bt", "Ct") else v)
            for k, v in c.items()}
    rest["h0"] = h1
    y2, h2 = run(mamba1_scan_reference, rest)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(h2, h, atol=1e-5, rtol=1e-5)


def test_h_last_is_the_model_path_state():
    """The same projections as tests/test_kernels.py's kernel-vs-model
    check; ``y`` plus the D-skip term and ``h_last`` against
    ``repro.models.ssm.mamba1_mix``."""
    import jax
    dims = JS.ssm_dims(SSMConfig(version=1, d_state=8, d_conv=4, expand=2,
                                 dt_rank=8, chunk=16), d_model=64)
    params = jax.tree.map(np.asarray, JS.ssm_init(jax.random.PRNGKey(4),
                                                  dims, jnp.float32))
    rng = np.random.default_rng(5)
    x_conv = rng.standard_normal((2, 32, dims.d_inner)).astype(np.float32)
    h0 = rng.standard_normal((2, dims.d_inner, dims.d_state)).astype(
        np.float32)
    y_model, h_model = JS.mamba1_mix(jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(x_conv), dims,
                                     h0=jnp.asarray(h0))
    n, rank = dims.d_state, dims.dt_rank
    xbc = x_conv @ params["w_x"]
    dt = np.logaddexp(0.0, xbc[..., :rank] @ params["w_dt"]
                      + params["dt_bias"]).astype(np.float32)
    A = -np.exp(params["A_log"])
    t = torch.from_numpy
    y, h = mamba1_scan(t(x_conv), t(dt), t(xbc[..., rank:rank + n].copy()),
                       t(xbc[..., rank + n:].copy()), t(A), t(h0))
    y = y.numpy() + params["D"] * x_conv
    np.testing.assert_allclose(y, np.asarray(y_model), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_model), **TOL)


def test_the_seam_computes_the_plain_version_on_the_cpu():
    c = to_torch(scan_case(2, 10, 64, 8, True), "cpu")
    before = mamba1_scan.launches
    got = ops.mamba_scan(c["x"], c["dt"], c["Bt"], c["Ct"], c["A"], c["h0"])
    want = run(mamba1_scan_reference, c)
    assert mamba1_scan.launches == before           # no kernel on the CPU
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_h_last_is_written_where_asked():
    """``h_out`` receives h_last and is returned; it may be ``h0`` itself,
    as at a decode step, which advances a cache entry in place."""
    c = to_torch(scan_case(2, 10, 64, 8, True), "cpu")
    want_y, want_h = run(mamba1_scan_reference, c)
    h0 = c["h0"].clone()
    for h_out in (torch.empty_like(h0), h0):        # elsewhere, then over h0
        y, h = ops.mamba_scan(c["x"], c["dt"], c["Bt"], c["Ct"], c["A"], h0,
                              h_out)
        assert h is h_out
        torch.testing.assert_close(y, want_y, atol=0, rtol=0)
        torch.testing.assert_close(h, want_h, atol=0, rtol=0)


def test_shape_checks_name_what_the_kernel_does_not_take():
    c = to_torch(scan_case(1, 4, 16, 8, True), "cpu")
    args = [c[k] for k in ("x", "dt", "Bt", "Ct", "A", "h0")]
    _check(*args)
    with pytest.raises(ValueError, match="N in"):
        _check(args[0], args[1], torch.zeros(1, 4, 12), torch.zeros(1, 4, 12),
               torch.zeros(16, 12), None)
    with pytest.raises(TypeError, match="float32"):
        _check(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="h0"):
        _check(*args[:5], args[5][:, :8])
    with pytest.raises(ValueError, match="A"):
        _check(*args[:4], args[4][:8], None)
    with pytest.raises(ValueError, match="want h_out"):
        _check(*args, torch.zeros(1, 8, 16))
    with pytest.raises(ValueError, match="h_out as one contiguous"):
        _check(*args, torch.zeros(1, 8, 16).transpose(1, 2))
