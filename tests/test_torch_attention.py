"""Ports of flash attention (B3) and decode attention (B2) against the JAX
package, and the model's attention seam, on the CPU.

The plain PyTorch versions (what the port's wrappers compute for CPU
tensors, and what the CUDA kernels are held against on the card) must
agree with ``repro``'s Pallas kernels in interpret mode and with
``repro.kernels.ref``, on the cases of tests/test_torch_attention_cuda.py:
tests/test_kernels.py's own, the ring, head dims 16/32/256, a GQA group of
48, ragged lengths and a decode row with no valid slot.  Tolerances are
tests/test_kernels.py's: atol = rtol = 2e-5 in float32 and 2e-2 in
bfloat16 (both sides take the same bf16-rounded inputs).
"""
from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention_bhd as jax_decode
from repro.kernels.flash_attention import flash_attention_bhsd as jax_flash
from repro.models.attention import head_layout as jax_head_layout
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_bhd
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.models.attention import head_layout
from test_torch_attention_cuda import (
    DTYPES,
    TOLS,
    decode_cases,
    flash_cases,
    model_decode,
    model_flash,
    run_decode,
    run_flash,
    to_torch,
)

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _jax(case, dtype):
    return {k: (jnp.asarray(v).astype(JNP[dtype]) if v.dtype == np.float32
                else jnp.asarray(v)) if isinstance(v, np.ndarray) else v
            for k, v in case.items()}


def _close(got, want, dtype):
    tol = TOLS[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,case", flash_cases(),
                         ids=[n for n, _ in flash_cases()])
def test_flash_plain_version_matches_jax(dtype, name, case):
    got = run_flash(flash_attention_bhsd, to_torch(case, "cpu", DTYPES[dtype]))
    j = _jax(case, dtype)
    _close(got, ref.flash_attention_ref(j["q"], j["k"], j["v"],
                                        causal=j["causal"],
                                        window=j["window"]), dtype)
    _close(got, jax_flash(j["q"], j["k"], j["v"], causal=j["causal"],
                          window=j["window"], blk_q=128, blk_k=128,
                          interpret=True), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,case", decode_cases(),
                         ids=[n for n, _ in decode_cases()])
def test_decode_plain_version_matches_jax(dtype, name, case):
    got = run_decode(decode_attention_bhd,
                     to_torch(case, "cpu", DTYPES[dtype]))
    j = _jax(case, dtype)
    args = (j["q"], j["k"], j["v"], j["cache_len"], j["positions"])
    _close(got, ref.decode_attention_ref(*args, window=j["window"]), dtype)
    _close(got, jax_decode(*args, window=j["window"], blk_s=64,
                           interpret=True), dtype)


def test_decode_row_with_no_valid_slot_is_the_mean_of_v():
    """cache_len 0: every score is -1e30, so the row is the uniform mean
    of V over all slots (the TPU kernel's semantics, kept)."""
    name, case = decode_cases()[-2]
    assert name.startswith("S64-D32") and case["cache_len"][0] == 0
    c = to_torch(case, "cpu", torch.float32)
    out = run_decode(decode_attention_bhd, c)
    H, KV = c["q"].shape[1], c["k"].shape[1]
    for h in range(H):
        torch.testing.assert_close(out[0, h], c["v"][0, h // (H // KV)].mean(0),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", (None, 16))
def test_model_layout_views_equal_contiguous_calls(window):
    """The [B, H, S, D] views the model passes compute what the same
    tensors made contiguous in the TPU kernel's [BH, S, D] layout do."""
    c = model_flash("cpu", torch.float32, window=window)
    got = run_flash(ops.flash_attention, c)
    flat = {k: (v.reshape(-1, *v.shape[2:]) if torch.is_tensor(v) else v)
            for k, v in c.items()}
    want = run_flash(flash_attention_bhsd, flat).reshape(got.shape)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    c = model_decode("cpu", torch.float32, window=window)
    got = run_decode(ops.decode_attention, c)
    want = run_decode(decode_attention_bhd,
                      {k: (v.contiguous() if torch.is_tensor(v) else v)
                       for k, v in c.items()})
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_cpu_wrappers_count_no_launch():
    before = (flash_attention_bhsd.launches, decode_attention_bhd.launches)
    run_flash(flash_attention_bhsd, model_flash("cpu", torch.float32))
    run_decode(decode_attention_bhd, model_decode("cpu", torch.float32))
    assert (flash_attention_bhsd.launches,
            decode_attention_bhd.launches) == before


def test_wrappers_raise_on_other_devices():
    """A device with neither a kernel (the card) nor a plain version (the
    CPU, and meta, where the dry-run traces) raises; meta gives the plain
    version's shapes."""
    other = types.SimpleNamespace(device=torch.device("xpu"), is_cuda=False,
                                  requires_grad=False)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_bhsd(other, other, other)
    with pytest.raises(ValueError, match="no kernel"):
        decode_attention_bhd(other, other, other, other, other)
    with pytest.raises(ValueError, match="no kernel"):      # B4, via the seam
        ops.mamba_scan(other, other, other, other, other)
    q = torch.zeros(2, 16, 64, device="meta")
    assert flash_attention_bhsd(q, q, q).shape == q.shape
    assert decode_attention_bhd(
        q[:, :1], q[:, None], q[:, None],
        torch.zeros(2, dtype=torch.int32, device="meta"),
        torch.zeros(2, 16, dtype=torch.int32, device="meta")).shape == (2, 1,
                                                                         64)
    x = torch.zeros(1, 4, 16, device="meta")
    bc = torch.zeros(1, 4, 8, device="meta")
    y, h = ops.mamba_scan(x, x, bc, bc, torch.zeros(16, 8, device="meta"))
    assert y.shape == x.shape and h.shape == (1, 16, 8)


@pytest.mark.parametrize("tp", (1, 2, 4, 16))
def test_head_layout_matches_jax_for_every_arch(tp):
    from repro.configs import ARCHS
    for name, cfg in sorted(ARCHS.items()):
        if not cfg.n_heads:
            continue
        want = jax_head_layout(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, tp)
        got = head_layout(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, tp)
        assert vars(got) == vars(want), name
