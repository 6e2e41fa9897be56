"""B2's split over the cache, on the CPU: the split rule the CUDA kernel
implements (``decode_attention_split_reference``: partial (m, l, o) per
split of whole tiles, merged in split order with a log-sum-exp rescale)
against the JAX package's decode attention (``repro.kernels
.decode_attention.decode_attention_bhd`` in interpret mode, and
``repro.kernels.ref.decode_attention_ref``) and the port's plain version.

Cases: tests/test_torch_attention_cuda.py's ``decode_cases()`` at several
split counts and tile sizes, and its ``split_decode_cases()`` (rows with
no kept slot, so every split is masked; a window and a ring whose kept
slots lie in one split).  Tolerances are tests/test_kernels.py's: atol =
rtol = 2e-5 in float32 and 2e-2 in bfloat16.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention_bhd as jax_decode
from repro_torch.kernels.decode_attention import (
    choose_splits,
    decode_attention_reference,
    decode_attention_split_reference,
    split_ranges,
    tile_slots,
)
from test_torch_attention_cuda import (
    DTYPES,
    TOLS,
    decode_cases,
    run_decode,
    split_decode_cases,
    to_torch,
)

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
SPLITS = (1, 2, 3, 1000)
CASES = dict(decode_cases())


@functools.lru_cache(maxsize=None)
def _jax_out(name: str, dtype: str):
    """The JAX package's two answers for a decode case, as float32."""
    case = CASES[name]
    j = {k: (jnp.asarray(v).astype(JNP[dtype]) if v.dtype == np.float32
             else jnp.asarray(v)) if isinstance(v, np.ndarray) else v
         for k, v in case.items()}
    args = (j["q"], j["k"], j["v"], j["cache_len"], j["positions"])
    return (np.asarray(ref.decode_attention_ref(*args, window=j["window"]),
                       np.float32),
            np.asarray(jax_decode(*args, window=j["window"], blk_s=64,
                                  interpret=True), np.float32))


def _close(got, want, dtype):
    tol = TOLS[dtype]
    if torch.is_tensor(want):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("n_splits", SPLITS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_rule_matches_jax(name, dtype, n_splits):
    c = to_torch(CASES[name], "cpu", DTYPES[dtype])
    # 16-slot tiles, so that even the short caches split several ways
    got = run_decode(decode_attention_split_reference, c, n_splits=n_splits,
                     tile=16)
    for want in _jax_out(name, dtype):
        _close(got, want, dtype)
    _close(got, run_decode(decode_attention_reference, c), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,case,n_splits", split_decode_cases(),
                         ids=[n for n, _, _ in split_decode_cases()])
def test_split_rule_on_the_card_cases(dtype, name, case, n_splits):
    """The card-only split cases, at the kernel's own tile size (``None``
    splits: as the wrapper would choose on a 132-SM card)."""
    c = to_torch(case, "cpu", DTYPES[dtype])
    B, H, D = c["q"].shape
    KV, S = c["k"].shape[1], c["k"].shape[2]
    tile = tile_slots(DTYPES[dtype], D)
    if n_splits is None:
        n_splits = choose_splits(B * KV * -(-(H // KV) // 16), S, tile, 132)
    got = run_decode(decode_attention_split_reference, c, n_splits=n_splits)
    _close(got, run_decode(decode_attention_reference, c), dtype)
    if case["cache_len"][-1] == 0:        # every split masked: mean of V
        mean = c["v"][-1].float().mean(1).repeat_interleave(H // KV, 0)
        _close(got[-1], mean, dtype)


def test_all_masked_splits_beside_kept_ones():
    """One row keeps slots only in its first split: the masked splits'
    m = -1e30 weighs exp(-1e30 - m) = 0 in the merge; a row with none kept
    averages V uniformly over every split."""
    rng = np.random.default_rng(3)
    S, D = 256, 32
    case = dict(q=rng.standard_normal((2, 4, D)).astype(np.float32),
                k=rng.standard_normal((2, 2, S, D)).astype(np.float32),
                v=rng.standard_normal((2, 2, S, D)).astype(np.float32),
                cache_len=np.asarray([20, 0], np.int32),
                positions=np.broadcast_to(np.arange(S, dtype=np.int32),
                                          (2, S)).copy(), window=None)
    c = to_torch(case, "cpu", torch.float32)
    got = run_decode(decode_attention_split_reference, c, n_splits=8)
    torch.testing.assert_close(got, run_decode(decode_attention_reference, c),
                               atol=2e-5, rtol=2e-5)
    mean = c["v"][1].mean(1).repeat_interleave(2, 0)
    torch.testing.assert_close(got[1], mean, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S,n,tile,want", [
    (544, 17, 64, 9), (544, 9, 64, 9), (4096, 3, 64, 3), (100, 3, 64, 2),
    (64, 5, 64, 1), (1, 4, 32, 1), (1000, 7, 64, 6)])
def test_split_ranges_cover_the_cache_in_whole_tiles(S, n, tile, want):
    ranges = split_ranges(S, n, tile)
    assert len(ranges) == want
    assert ranges[0][0] == 0 and ranges[-1][1] == S
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2 and lo % tile == 0 and hi > lo


def test_choose_splits_fills_two_waves():
    # qwen2-0.5b's decode at 8 rows: 16 groups over 9 tiles of 544 slots
    assert choose_splits(16, 544, 64, 132) == 9
    # 64 rows over 4096 slots: 128 groups, 3 splits
    assert choose_splits(128, 4096, 64, 132) == 3
    # one group over a long cache: at most 16, merged by one block
    assert choose_splits(2, 8192, 64, 132) == 16
    # many groups need no split; a one-tile cache cannot split
    assert choose_splits(512, 4096, 64, 132) == 1
    assert choose_splits(1, 40, 64, 132) == 1


LSE_CASES = {n.rsplit("-splits", 1)[0]: c for n, c, _ in split_decode_cases()}


@pytest.mark.parametrize("name", sorted(LSE_CASES))
def test_lse_merges_disjoint_slot_ranges(name):
    """The plain version's log-sum-exp is what merges results over
    disjoint slot ranges (a cache sharded on its slots): the two halves'
    outputs, weighted by exp(lse - max), give the whole cache's output,
    and their log-sum-exps its log-sum-exp (float32, 2e-5)."""
    c = to_torch(LSE_CASES[name], "cpu", torch.float32)
    S = c["k"].shape[2]
    whole, lse = run_decode(decode_attention_reference, c, with_lse=True)
    parts = []
    for sl in (slice(0, S // 2), slice(S // 2, S)):
        half = dict(c, k=c["k"][:, :, sl], v=c["v"][:, :, sl],
                    positions=c["positions"][:, sl].contiguous())
        parts.append(run_decode(decode_attention_reference, half,
                                with_lse=True))
    m = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.exp(l_ - m)[..., None] for _, l_ in parts]
    merged = (w[0] * parts[0][0] + w[1] * parts[1][0]) / (w[0] + w[1])
    torch.testing.assert_close(merged, whole, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(torch.logaddexp(parts[0][1], parts[1][1]),
                               lse, atol=2e-5, rtol=2e-5)
