"""Port of paged decode attention (B1) against the JAX package.

The plain PyTorch version (what the port's wrapper computes for CPU
tensors, and what the CUDA kernel is held against on the card) must agree
with ``repro``'s Pallas kernel in interpret mode and with its gather
reference, at the JAX package's own tolerance (atol = rtol = 1e-5,
tests/test_backend.py), for fp32 and int8 pools, GQA groups r in
{1, 2, 7}, head dims 16 and 64, block sizes 8 and 16, ragged lengths,
-1 table entries inside and past the valid range, and seq_len-0 rows,
which return the uniform mean of V over the gathered slots.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode_attention import (
    paged_decode_attention as jax_paged_attention,
    paged_decode_attention_reference as jax_reference,
)
from repro_torch.kernels.paged_decode_attention import (
    dequantize_pages,
    paged_decode_attention,
    paged_decode_attention_reference,
)
from test_torch_kernels_cuda import KV, TOL, make_case


def _split(case, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    args = [conv(case[k]) for k in
            ("q", "k_pages", "v_pages", "block_tables", "seq_lens")]
    kw = {k: conv(case[k]) for k in ("k_scales", "v_scales") if k in case}
    return args, kw


@pytest.mark.parametrize("quantized", (False, True), ids=("fp32", "int8"))
@pytest.mark.parametrize("r", (1, 2, 7))
@pytest.mark.parametrize("D", (16, 64))
@pytest.mark.parametrize("block", (8, 16))
def test_plain_version_matches_jax(quantized, r, D, block):
    case = make_case(100 * r + D + block, r=r, D=D, block=block,
                     quantized=quantized)
    jargs, jkw = _split(case, "jax")
    targs, tkw = _split(case, "torch")
    got = paged_decode_attention(*targs, **tkw).numpy()
    kernel = np.asarray(jax_paged_attention(*jargs, **jkw, interpret=True))
    ref = np.asarray(jax_reference(*jargs, **jkw))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, kernel, **TOL)


@pytest.mark.parametrize("quantized", (False, True), ids=("fp32", "int8"))
def test_masked_rows_are_uniform_mean_of_gathered_v(quantized):
    """seq_len 0 (and all -1 pages) attend nothing, and still return the
    mean of V over every gathered slot (-1 entries read page 0) — the
    TPU kernel's semantics, which the port keeps."""
    case = make_case(5, r=2, D=16, block=8, quantized=quantized)
    args, kw = _split(case, "torch")
    out = paged_decode_attention(*args, **kw)
    v = args[2]
    if quantized:
        v = dequantize_pages(v, kw["v_scales"])
    for b in (2, 4, 6):
        pages = args[3][b].long().clamp(min=0)
        for g in range(KV):
            want = v[g, pages].reshape(-1, v.shape[-1]).mean(0)
            for i in range(2):
                torch.testing.assert_close(out[b, 2 * g + i], want,
                                           **TOL)


def test_cpu_wrapper_counts_no_launch():
    case = make_case(1, r=2, D=16, block=8, quantized=False)
    args, _ = _split(case, "torch")
    before = paged_decode_attention.launches
    torch.testing.assert_close(paged_decode_attention(*args),
                               paged_decode_attention_reference(*args))
    assert paged_decode_attention.launches == before
