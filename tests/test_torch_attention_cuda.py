"""The CUDA kernels of flash attention (B3) and decode attention (B2)
against their plain versions, on the card.

These tests need the card (marker ``cuda``) and skip without one.  They
import neither JAX nor ``repro``, so that they run where only the port is
installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_attention_cuda.py

The cases: those of tests/test_kernels.py (MHA, GQA, MQA; causal,
bidirectional and window 64; decode with and without a window; the ring
case), head dims 16, 32 and 256, a GQA group of 48 (granite-20b's MQA),
ragged lengths that are no multiple of a tile, a decode row with no valid
slot, and the model's own layouts at qwen2-0.5b's heads (H 14, KV 2,
D 64): ``[B, S, H, D]`` activations and a ``[B, S, KV, D]`` cache read
through transposed views, also at the model paths' own shapes (a prefill
of 8 x 512 tokens and the decode steps over its 544-slot cache) at the
heads of qwen2-0.5b and of zamba2-1.2b's shared block (H 32, KV 32).  float32 and bfloat16, atol = rtol = 2e-5 and
2e-2 (tests/test_kernels.py's tolerances).  The builders below also feed
tests/test_torch_attention.py (the plain versions against the JAX package
on the CPU) and ``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (
    decode_attention_bhd,
    decode_attention_reference,
)
from repro_torch.kernels.flash_attention import (
    flash_attention_bhsd,
    flash_attention_reference,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}

# (S, D, BH, BKV): tests/test_kernels.py's four, then D 16/32/256, r 48 and
# lengths that are no multiple of a tile
FLASH_SHAPES = [(256, 64, 4, 4), (512, 128, 8, 2), (256, 128, 6, 1),
                (128, 64, 2, 2), (128, 16, 4, 2), (96, 32, 6, 3),
                (64, 256, 4, 2), (80, 64, 48, 1)]
FLASH_MASKS = [(True, None), (False, None), (True, 64)]
# (S, D, H, KV, cache_len, window): tests/test_kernels.py's four, then the
# same extensions; cache_len 0 for the first row of the last one
DECODE_SHAPES = [(256, 64, 8, 8, 200, None), (512, 128, 8, 2, 511, None),
                 (256, 128, 4, 1, 64, None), (128, 64, 8, 4, 100, 32),
                 (64, 16, 4, 2, 40, None), (96, 32, 6, 3, 50, 16),
                 (128, 256, 4, 2, 90, None), (200, 64, 48, 1, 77, None),
                 (64, 32, 4, 2, 0, None)]


def flash_cases():
    """[(id, case)]: each case is the numpy inputs of one B3 call."""
    out = []
    for S, D, BH, BKV in FLASH_SHAPES:
        rng = np.random.default_rng(S + 7 * D + 31 * BH + BKV)
        q = rng.standard_normal((BH, S, D)).astype(np.float32)
        k = rng.standard_normal((BKV, S, D)).astype(np.float32)
        v = rng.standard_normal((BKV, S, D)).astype(np.float32)
        for causal, window in FLASH_MASKS:
            name = (f"S{S}-D{D}-BH{BH}-BKV{BKV}-"
                    f"{'causal' if causal else 'bidir'}-w{window}")
            out.append((name, dict(q=q, k=k, v=v, causal=causal,
                                   window=window)))
    return out


def decode_cases():
    """[(id, case)]: each case is the numpy inputs of one B2 call."""
    out = []
    for S, D, H, KV, clen, window in DECODE_SHAPES:
        B = 2
        rng = np.random.default_rng(S + 7 * D + 31 * H + KV)
        lens = [clen, max(clen - 7, 1)]
        out.append((f"S{S}-D{D}-H{H}-KV{KV}-len{clen}-w{window}", dict(
            q=rng.standard_normal((B, H, D)).astype(np.float32),
            k=rng.standard_normal((B, KV, S, D)).astype(np.float32),
            v=rng.standard_normal((B, KV, S, D)).astype(np.float32),
            cache_len=np.asarray(lens, np.int32),
            positions=np.broadcast_to(np.arange(S, dtype=np.int32),
                                      (B, S)).copy(),
            window=window)))
    # the ring: slot j holds the position p <= 79 with p % 64 == j
    rng = np.random.default_rng(2)
    j = np.arange(64, dtype=np.int32)
    out.append(("ring-S64-len80-w48", dict(
        q=rng.standard_normal((1, 4, 64)).astype(np.float32),
        k=rng.standard_normal((1, 4, 64, 64)).astype(np.float32),
        v=rng.standard_normal((1, 4, 64, 64)).astype(np.float32),
        cache_len=np.asarray([80], np.int32),
        positions=(79 - (79 - j) % 64)[None].astype(np.int32), window=48)))
    return out


def to_torch(case, device, dtype):
    """Tensors of a case: floats in ``dtype``, ints as they are."""
    conv = {}
    for key, val in case.items():
        if isinstance(val, np.ndarray):
            t = torch.from_numpy(val).to(device)
            conv[key] = t.to(dtype) if t.is_floating_point() else t
        else:
            conv[key] = val
    return conv


def model_flash(device, dtype, *, B=2, S=100, H=14, KV=2, D=64, window=None):
    """B3's inputs as the model passes them: [B, H, S, D] views of
    [B, S, H, D] activations."""
    g = torch.Generator().manual_seed(S + H)
    q, k, v = (torch.randn((B, S, n, D), generator=g).to(device, dtype)
               for n in (H, KV, KV))
    return dict(q=q.transpose(1, 2), k=k.transpose(1, 2), v=v.transpose(1, 2),
                causal=True, window=window)


def model_decode(device, dtype, *, B=3, Sc=130, H=14, KV=2, D=64,
                 window=None):
    """B2's inputs as the model passes them: a [B, KV, Sc, D] view of the
    [B, Sc, KV, D] cache, positions broadcast over the batch, ragged
    lengths."""
    g = torch.Generator().manual_seed(Sc + H)
    kc, vc = (torch.randn((B, Sc, KV, D), generator=g).to(device, dtype)
              for _ in range(2))
    q = torch.randn((B, 1, H, D), generator=g).to(device, dtype)
    lens = torch.tensor([Sc, Sc // 2, 1][:B], dtype=torch.int32, device=device)
    pos = torch.arange(Sc, dtype=torch.int32, device=device).expand(B, Sc)
    return dict(q=q[:, 0], k=kc.transpose(1, 2), v=vc.transpose(1, 2),
                cache_len=lens, positions=pos, window=window)


def model_path_decode(device, dtype, valid: int, *, H=14, KV=2) -> dict:
    """B2's inputs as a model path's decode steps give them: 8 rows over a
    [8, 544, KV, 64] cache (512 prompt slots grown by 32), one ``valid``
    length shared by every row (a broadcast [B] tensor, stride 0) and
    linear slot positions."""
    c = model_decode(device, dtype, B=8, Sc=544, H=H, KV=KV)
    c["cache_len"] = torch.tensor([valid], dtype=torch.int32,
                                  device=device).expand(8)
    return c


# the heads of the model paths chip_smoke.py drives: qwen2-0.5b's
# attention layers and zamba2-1.2b's shared block
MODEL_HEADS = {"qwen2-0.5b": (14, 2), "zamba2-1.2b": (32, 32)}


def run_flash(fn, c):
    return fn(c["q"], c["k"], c["v"], causal=c["causal"], window=c["window"])


def run_decode(fn, c):
    return fn(c["q"], c["k"], c["v"], c["cache_len"], c["positions"],
              window=c["window"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _check(got, want, dtype_name):
    tol = TOLS[dtype_name]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,case", flash_cases(),
                         ids=[n for n, _ in flash_cases()])
def test_flash_kernel_matches_plain_version(cuda_device, dtype, name, case):
    c = to_torch(case, cuda_device, DTYPES[dtype])
    before = flash_attention_bhsd.launches
    got = run_flash(flash_attention_bhsd, c)
    torch.cuda.synchronize()
    assert flash_attention_bhsd.launches == before + 1
    _check(got, run_flash(flash_attention_reference, c), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,case", decode_cases(),
                         ids=[n for n, _ in decode_cases()])
def test_decode_kernel_matches_plain_version(cuda_device, dtype, name, case):
    c = to_torch(case, cuda_device, DTYPES[dtype])
    before = decode_attention_bhd.launches
    got = run_decode(decode_attention_bhd, c)
    torch.cuda.synchronize()
    assert decode_attention_bhd.launches == before + 1
    _check(got, run_decode(decode_attention_reference, c), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window", (None, 16))
def test_kernels_read_the_model_layouts(cuda_device, dtype, window):
    c = model_flash(cuda_device, DTYPES[dtype], window=window)
    got = run_flash(flash_attention_bhsd, c)
    assert got.shape == c["q"].shape
    _check(got, run_flash(flash_attention_reference, c), dtype)
    c = model_decode(cuda_device, DTYPES[dtype], window=window)
    got = run_decode(decode_attention_bhd, c)
    torch.cuda.synchronize()
    _check(got, run_decode(decode_attention_reference, c), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", sorted(MODEL_HEADS))
def test_kernels_at_the_model_path_shapes(cuda_device, dtype, arch):
    """B3 at the prefill of 8 x 512 tokens and B2 at the decode steps that
    follow it (8 rows over 544 slots, lengths 513 and 544), at the heads
    of each model path."""
    H, KV = MODEL_HEADS[arch]
    c = model_flash(cuda_device, DTYPES[dtype], B=8, S=512, H=H, KV=KV)
    got = run_flash(flash_attention_bhsd, c)
    torch.cuda.synchronize()
    _check(got, run_flash(flash_attention_reference, c), dtype)
    for valid in (513, 544):
        c = model_path_decode(cuda_device, DTYPES[dtype], valid, H=H, KV=KV)
        got = run_decode(decode_attention_bhd, c)
        torch.cuda.synchronize()
        _check(got, run_decode(decode_attention_reference, c), dtype)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(2, 16, 24, device=cuda_device)       # D 24 is not built
    with pytest.raises(ValueError):
        flash_attention_bhsd(q, q, q)
    q = torch.zeros(2, 16, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention_bhsd(q, q, q)
    c = to_torch(decode_cases()[0][1], cuda_device, torch.float32)
    with pytest.raises(TypeError):                        # int64 lengths
        decode_attention_bhd(c["q"], c["k"], c["v"], c["cache_len"].long(),
                             c["positions"])
    with pytest.raises(ValueError):                       # r = 64 > 48
        decode_attention_bhd(torch.zeros(2, 64, 64, device=cuda_device),
                             c["k"][:, :1], c["v"][:, :1], c["cache_len"],
                             c["positions"])
