"""The CUDA kernel of paged decode attention against its plain version.

These tests need the card (marker ``cuda``) and skip without one.  They
import neither JAX nor ``repro``, so that they run where only the port is
installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

``make_case`` also feeds tests/test_torch_paged_attention.py, which holds
the plain version against the JAX package on the CPU.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_decode_attention import (
    paged_decode_attention,
    paged_decode_attention_reference,
)

TOL = dict(atol=1e-5, rtol=1e-5)
KV = 2


def make_case(seed: int, *, r: int, D: int, block: int, quantized: bool):
    """Seeded inputs as numpy arrays.  Rows: ragged lengths, a -1 page in
    the middle of a valid range, a seq_len-0 row on real pages, a
    seq_len-0 row of -1 entries, and a row whose only pages are -1."""
    rng = np.random.default_rng(seed)
    H, N, nb = r * KV, 24, 5
    lens = [3 * block + 5, block, 0, 2 * block + 1, 0, block + 3, 4]
    B = len(lens)
    perm = rng.permutation(N)
    bt = np.full((B, nb), -1, np.int32)
    used = 0
    for b, n_tok in enumerate(lens):
        n_pages = -(-n_tok // block)
        bt[b, :n_pages] = perm[used:used + n_pages]
        used += n_pages
    bt[0, 1] = -1                       # masked page inside the valid range
    bt[2, :2] = perm[used:used + 2]     # seq_len 0 on real pages
    bt[6, :] = -1                       # seq_len 4 but only -1 entries
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    case = dict(q=q, block_tables=bt, seq_lens=np.asarray(lens, np.int32))
    if quantized:
        shape = (KV, N, block, D)
        case["k_pages"] = rng.integers(-127, 128, shape).astype(np.int8)
        case["v_pages"] = rng.integers(-127, 128, shape).astype(np.int8)
        case["k_scales"] = rng.uniform(0.1, 3.0, (KV, N)).astype(np.float32)
        case["v_scales"] = rng.uniform(0.1, 3.0, (KV, N)).astype(np.float32)
    else:
        for name in ("k_pages", "v_pages"):
            case[name] = rng.standard_normal(
                (KV, N, block, D)).astype(np.float32)
    return case


def _torch(case):
    args = [torch.from_numpy(case[k]) for k in
            ("q", "k_pages", "v_pages", "block_tables", "seq_lens")]
    kw = {k: torch.from_numpy(case[k]) for k in ("k_scales", "v_scales")
          if k in case}
    return args, kw


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", (False, True), ids=("fp32", "int8"))
@pytest.mark.parametrize("r", (1, 2, 7, 16))
@pytest.mark.parametrize("D", (16, 32, 64, 128))
def test_kernel_matches_plain_version_on_card(cuda_device, quantized, r, D):
    case = make_case(r + D, r=r, D=D, block=16, quantized=quantized)
    args, kw = _torch(case)
    args = [a.to(cuda_device) for a in args]
    kw = {k: v.to(cuda_device) for k, v in kw.items()}
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    torch.testing.assert_close(
        got, paged_decode_attention_reference(*args, **kw), **TOL)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    case = make_case(2, r=2, D=16, block=8, quantized=False)
    args, _ = _torch(case)
    args = [a.to(cuda_device) for a in args]
    with pytest.raises(ValueError):          # head dim 24 is not built
        paged_decode_attention(torch.zeros(7, 4, 24, device=cuda_device),
                               *args[1:])
    with pytest.raises(TypeError):           # int64 tables
        paged_decode_attention(args[0], args[1], args[2], args[3].long(),
                               args[4])
