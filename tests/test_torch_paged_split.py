"""B1's split over pages, on the CPU: the split rule the CUDA kernel
implements (``paged_decode_attention_split_reference``: partial (m, l, o)
per split of whole pages, over the pages each row walks, merged in split
order with a log-sum-exp rescale) against the JAX package's paged decode
attention (``repro.kernels.paged_decode_attention`` in interpret mode, and
its gather reference) and the port's plain version, fp32 and int8, at the
JAX package's tolerance (atol = rtol = 1e-5, tests/test_backend.py).

Cases: ``make_case``'s rows (tests/test_torch_kernels_cuda.py): ragged
lengths, a -1 entry inside a valid range, seq_len-0 rows on real pages and
on -1 pages, and a row of only -1 pages, at split counts 1, 2, 3 and nb.
Then the split rule itself, and the wrappers' cached checks: after a valid
call, an input of the same shapes that ``_check`` refused is refused
again.
"""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_decode_attention import (
    paged_decode_attention as jax_paged_attention,
    paged_decode_attention_reference as jax_reference,
)
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import paged_decode_attention as PA
from test_torch_kernels_cuda import KV, TOL, make_case
from test_torch_mamba_scan_cuda import scan_case, to_torch

NB = 5                          # make_case's table width
SPLITS = (1, 2, 3, NB)


@functools.lru_cache(maxsize=None)
def _case(quantized: bool, r: int, D: int, block: int):
    return make_case(1000 + 100 * r + D + block, r=r, D=D, block=block,
                     quantized=quantized)


@functools.lru_cache(maxsize=None)
def _jax_out(quantized: bool, r: int, D: int, block: int):
    """The JAX package's two answers for a case: the Pallas kernel in
    interpret mode and the gather reference."""
    case = _case(quantized, r, D, block)
    args = [jnp.asarray(case[k]) for k in
            ("q", "k_pages", "v_pages", "block_tables", "seq_lens")]
    kw = {k: jnp.asarray(case[k]) for k in ("k_scales", "v_scales")
          if k in case}
    return (np.asarray(jax_paged_attention(*args, **kw, interpret=True)),
            np.asarray(jax_reference(*args, **kw)))


def _torch(case):
    args = [torch.from_numpy(case[k]) for k in
            ("q", "k_pages", "v_pages", "block_tables", "seq_lens")]
    kw = {k: torch.from_numpy(case[k]) for k in ("k_scales", "v_scales")
          if k in case}
    return args, kw


@pytest.mark.parametrize("n_splits", SPLITS)
@pytest.mark.parametrize("quantized", (False, True), ids=("fp32", "int8"))
@pytest.mark.parametrize("r", (1, 2, 7))
@pytest.mark.parametrize("D", (16, 64))
@pytest.mark.parametrize("block", (8, 16))
def test_split_rule_matches_jax(quantized, r, D, block, n_splits):
    args, kw = _torch(_case(quantized, r, D, block))
    got = PA.paged_decode_attention_split_reference(*args, **kw,
                                                    n_splits=n_splits)
    for want in _jax_out(quantized, r, D, block):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch.testing.assert_close(
        got, PA.paged_decode_attention_reference(*args, **kw), **TOL)


@pytest.mark.parametrize("quantized", (False, True), ids=("fp32", "int8"))
def test_masked_rows_stay_the_uniform_mean_across_splits(quantized):
    """seq_len-0 rows (on real and on -1 pages) and the row of only -1
    pages walk all nb pages in every split, each split's state m = -1e30,
    and the merge gives the mean of V over every gathered slot."""
    args, kw = _torch(_case(quantized, 2, 16, 8))
    v = args[2]
    if quantized:
        v = PA.dequantize_pages(v, kw["v_scales"])
    for n in SPLITS:
        out = PA.paged_decode_attention_split_reference(*args, **kw,
                                                        n_splits=n)
        for b in (2, 4, 6):
            pages = args[3][b].long().clamp(min=0)
            for g in range(KV):
                want = v[g, pages].reshape(-1, v.shape[-1]).mean(0)
                for i in range(2):
                    torch.testing.assert_close(out[b, 2 * g + i], want,
                                               **TOL)


def test_pages_walked_stop_at_each_rows_length():
    """make_case's rows at block 8: lengths 29, 8, 0, 17, 0, 11, 4; row 0
    has a -1 page inside its range, row 2 a length of 0 on real pages,
    row 4 on -1 pages, row 6 only -1 pages."""
    args, _ = _torch(_case(False, 1, 16, 8))
    walked = PA.pages_walked(args[3], args[4], 8)
    assert walked.tolist() == [4, 1, NB, 3, NB, 2, NB]


def test_no_split_reaches_past_a_rows_pages():
    """A split that starts past the pages a row walks is empty and weighs
    nothing: the result equals the split of the walked pages alone."""
    rng = np.random.default_rng(11)
    block, D, nb, N = 8, 16, 12, 40
    case = dict(q=rng.standard_normal((2, 4, D)).astype(np.float32),
                k_pages=rng.standard_normal((KV, N, block, D)).astype(
                    np.float32),
                v_pages=rng.standard_normal((KV, N, block, D)).astype(
                    np.float32),
                block_tables=rng.permutation(N)[:2 * nb].reshape(2, nb)
                .astype(np.int32),
                seq_lens=np.asarray([13, 3], np.int32))   # 2 and 1 pages
    args, _ = _torch(case)
    want = PA.paged_decode_attention_reference(*args)
    for n in (1, 2, 6, nb):
        got = PA.paged_decode_attention_split_reference(*args, n_splits=n)
        torch.testing.assert_close(got, want, **TOL)
    # every split but the first is empty at 6 splits of 2 pages: the first
    # alone gives the answer
    assert PA.split_ranges(nb, 6)[0] == (0, 2)


@pytest.mark.parametrize("nb,n,want", [
    (32, 2, 2), (32, 16, 16), (32, 3, 3), (5, 3, 3), (5, 4, 3), (5, 9, 5),
    (1, 4, 1), (7, 7, 7)])
def test_split_ranges_cover_the_table_in_whole_pages(nb, n, want):
    ranges = PA.split_ranges(nb, n)
    assert len(ranges) == want
    assert ranges[0][0] == 0 and ranges[-1][1] == nb
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2 and hi > lo


def test_choose_splits_fills_the_sms_and_is_capped():
    # 64 rows, qwen2-0.5b's 2 kv heads and 7 query heads a kv head: 128
    # groups, two blocks per SM of 132 -> 2 splits of 16 pages; an SM that
    # holds four (smaller int8 stages) -> 4 splits
    assert PA.choose_splits(128, 32, 132) == 2
    assert PA.choose_splits(128, 32, 132, per_sm=4) == 4
    assert PA.choose_splits(128, 32, 132, per_sm=0) == 1
    # the serve runs' 8 rows: 16 groups -> 16 splits of 2 pages
    assert PA.choose_splits(16, 32, 132) == 16
    # at most MAX_SPLITS, at most one per page, at least one
    assert PA.choose_splits(1, 1000, 132) == PA.MAX_SPLITS
    assert PA.choose_splits(2, 5, 132) == 5
    assert PA.choose_splits(4096, 32, 132) == 1


def test_paged_cached_checks_still_refuse_after_a_valid_call():
    case = _case(True, 2, 16, 8)
    args, kw = _torch(case)
    q, kp, vp, bt, sl = args
    ks, vs = kw["k_scales"], kw["v_scales"]
    for _ in range(2):                       # the second call hits the cache
        assert PA._checked(q, kp, vp, bt, sl, ks, vs) is True
    with pytest.raises(TypeError):           # int64 tables, same shape
        PA._checked(q, kp, vp, bt.long(), sl, ks, vs)
    with pytest.raises(TypeError):           # float64 q
        PA._checked(q.double(), kp, vp, bt, sl, ks, vs)
    with pytest.raises(ValueError):          # int8 pages without scales
        PA._checked(q, kp, vp, bt, sl, None, None)
    with pytest.raises(ValueError):          # float64 scales
        PA._checked(q, kp, vp, bt, sl, ks.double(), vs)
    with pytest.raises(TypeError):           # k and v of two dtypes
        PA._checked(q, kp, vp.float(), bt, sl, ks, vs)
    strided = torch.empty(q.shape[0], q.shape[1], 2 * q.shape[2])[..., ::2]
    strided.copy_(q)
    with pytest.raises(ValueError, match="contiguous"):
        PA._checked(strided, kp, vp, bt, sl, ks, vs)
    with pytest.raises(ValueError, match="tensors on"):
        PA._checked(q, kp, vp, bt, sl.to("meta"), ks, vs)
    with pytest.raises(ValueError):          # head dim 24 is not built
        PA._checked(torch.zeros(7, 4, 24), kp, vp, bt, sl, ks, vs)
    assert PA._checked(q, kp, vp, bt, sl, ks, vs) is True


def test_scan_cached_checks_still_refuse_after_a_valid_call():
    c = to_torch(scan_case(1, 4, 16, 8, True), "cpu")
    args = [c[k] for k in ("x", "dt", "Bt", "Ct", "A", "h0")]
    h_out = torch.empty_like(c["h0"])
    for _ in range(2):                       # the second call hits the cache
        strides = MS._checked(*args, h_out)
    assert strides == (*c["Bt"].stride()[:2], *c["Ct"].stride()[:2])
    with pytest.raises(TypeError, match="float32"):
        MS._checked(args[0].double(), *args[1:], h_out)
    with pytest.raises(TypeError, match="float32"):
        MS._checked(*args, h_out.double())
    with pytest.raises(ValueError, match="h_out as one contiguous"):
        MS._checked(*args, torch.zeros(1, 8, 16).transpose(1, 2))
    with pytest.raises(ValueError, match="different devices"):
        MS._checked(*args[:5], args[5].to("meta"), h_out)
    with pytest.raises(ValueError, match="N in"):
        MS._checked(args[0], args[1], torch.zeros(1, 4, 12),
                    torch.zeros(1, 4, 12), torch.zeros(16, 12), None, None)
    with pytest.raises(ValueError, match="h0"):
        MS._checked(*args[:5], args[5][:, :8], None)
    assert MS._checked(*args, h_out) == strides
