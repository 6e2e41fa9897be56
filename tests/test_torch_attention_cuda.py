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
heads of qwen2-0.5b and of zamba2-1.2b's shared block (H 32, KV 32).
float32 and bfloat16 (``KERNEL_TOLS``): atol = rtol = 2e-5 in float32; in
bfloat16 rtol = 2e-2 (tests/test_kernels.py's) with an atol of about twice
the worst excess of an error over rtol times the plain value measured on
the H100 (PERF.md): 2e-3 for B2, 8e-3 for B3, whose P is rounded to bf16
before P·V (at most 2^-9 of each term, about 9e-3 when the terms of a
short row cancel).  Both are well under 2e-2, about a typical output
element at 4096 slots, so that a kernel that drops one tile fails.

B3's tensor-core route (bf16 at D 64/128/256) has cases of its own
(``wgmma_flash_cases``): every D, sequence lengths around a tile (1, 63,
64, 65, 100, 512), causal, bidirectional and window 16, GQA groups of 1, 7
and 48, batches of 1 and 3, all through the model's [B, S, H, D] views.
Whisper-small's shapes have their own (``whisper_flash``,
``whisper_cross_decode``): B3 over its encoder's 8 x 1,500 frames,
bidirectional, 12/12 heads at D 64 (1,500 is no multiple of the 64-row
tile), and B2 over its cross-attention's 1,500 slots, all valid, for 8
rows, in bf16 (the model path's) and float32.
B2's split over the cache has its own (``split_decode_cases``): split
counts from 1 to one per tile, a row with no kept slot (all its splits
masked: the uniform mean of V), a ring whose kept slots lie in one split,
a window, groups of 1, 7 and 48.  Both kernels must give bitwise-equal
outputs on two calls, and the route counter must show the bf16 model
shapes on the tensor-core kernel.

The builders below also feed tests/test_torch_attention.py and
tests/test_torch_decode_split.py (the plain versions and the split rule
against the JAX package on the CPU) and ``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import _launch as launch_decode
from repro_torch.kernels.decode_attention import (
    decode_attention_bhd,
    decode_attention_reference,
    tile_slots,
)
from repro_torch.kernels.flash_attention import (
    WGMMA_HEAD_DIMS,
    flash_attention_bhsd,
    flash_attention_reference,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOLS = {"float32": 2e-5, "bfloat16": 2e-2}     # tests/test_kernels.py's
KERNEL_TOLS = {kind: {"float32": dict(atol=2e-5, rtol=2e-5),
                      "bfloat16": dict(atol=atol, rtol=2e-2)}
               for kind, atol in (("flash", 8e-3), ("decode", 2e-3))}

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


# B3's tensor-core route: (D, S, mask) crossed, the GQA group and the
# batch cycling through (1, 7, 48) and (1, 3)
WGMMA_SEQS = (1, 63, 64, 65, 100, 512)
WGMMA_MASKS = {"causal": (True, None), "bidir": (False, None),
               "w16": (True, 16)}


def wgmma_flash_cases():
    """[(id, params)] for ``wgmma_flash``."""
    out = []
    for D in WGMMA_HEAD_DIMS:
        for S in WGMMA_SEQS:
            for mask in WGMMA_MASKS:
                i = len(out)
                r, B = (1, 7, 48)[i % 3], (1, 3)[i % 2]
                out.append((f"D{D}-S{S}-{mask}-r{r}-B{B}",
                            dict(D=D, S=S, mask=mask, r=r, B=B)))
    return out


def wgmma_flash(device, *, D, S, mask, r, B):
    """bf16 B3 inputs through the model's [B, S, H, D] views; r 48 is
    granite-20b's MQA (KV 1), else KV 2."""
    KV = 1 if r == 48 else 2
    causal, window = WGMMA_MASKS[mask]
    c = model_flash(device, torch.bfloat16, B=B, S=S, H=r * KV, KV=KV, D=D,
                    window=window)
    c["causal"] = causal
    return c


# whisper-small: 8 rows, its encoder's 1,500 frames, 12/12 heads at D 64
WHISPER = dict(B=8, T=1500, H=12, KV=12, D=64)


def whisper_flash(device, dtype) -> dict:
    """B3 at whisper's encoder: bidirectional over 8 x 1,500 frames."""
    w = WHISPER
    c = model_flash(device, dtype, B=w["B"], S=w["T"], H=w["H"], KV=w["KV"],
                    D=w["D"])
    c["causal"] = False
    return c


def whisper_cross_decode(device, dtype) -> dict:
    """B2 at whisper's cross-attention decode: 8 rows over the encoder's
    1,500 slots, every slot valid (the model's ``DecodeStep.every_slot``:
    a broadcast length, linear positions)."""
    w = WHISPER
    c = model_decode(device, dtype, B=w["B"], Sc=w["T"], H=w["H"],
                     KV=w["KV"], D=w["D"])
    c["cache_len"] = torch.full((1,), w["T"], dtype=torch.int32,
                                device=device).expand(w["B"])
    return c


def split_decode_cases():
    """[(id, case, n_splits)]: numpy B2 inputs with a forced split count
    (None: the wrapper's rule).  The case names say what each holds."""
    out = []
    rng = np.random.default_rng(5)
    for r, S, D in ((1, 1000, 64), (7, 544, 64), (48, 300, 128)):
        KV = 1 if r == 48 else 2
        B = 3
        case = dict(
            q=rng.standard_normal((B, r * KV, D)).astype(np.float32),
            k=rng.standard_normal((B, KV, S, D)).astype(np.float32),
            v=rng.standard_normal((B, KV, S, D)).astype(np.float32),
            # a full row, a ragged one, a row with no kept slot
            cache_len=np.asarray([S, S // 2 + 3, 0], np.int32),
            positions=np.broadcast_to(np.arange(S, dtype=np.int32),
                                      (B, S)).copy(), window=None)
        for n in (1, 2, 3, 7, 1000, None):
            out.append((f"r{r}-S{S}-D{D}-splits{n}", case, n))
    # a window of 40 over 1000 slots: the full row keeps slots in the last
    # of 4 splits only
    w = dict(out[2][1], window=40)
    for n in (4, None):
        out.append((f"r1-S1000-D64-w40-splits{n}", w, n))
    # a ring of 256 slots holding positions 0..1279 (cache_len 1280): slot
    # j holds the last p with p % 256 == j, and a window of 60 keeps only
    # slots 196..255, which lie in the last of 4 splits
    S, D = 256, 64
    j = np.arange(S, dtype=np.int32)
    ring = dict(
        q=rng.standard_normal((2, 14, D)).astype(np.float32),
        k=rng.standard_normal((2, 2, S, D)).astype(np.float32),
        v=rng.standard_normal((2, 2, S, D)).astype(np.float32),
        cache_len=np.asarray([1280, 1280], np.int32),
        positions=np.broadcast_to(1279 - (1279 - j) % S, (2, S)).astype(
            np.int32).copy(), window=60)
    for n in (1, 4):
        out.append((f"ring-S256-len1280-w60-splits{n}", ring, n))
    return out


def run_flash(fn, c):
    return fn(c["q"], c["k"], c["v"], causal=c["causal"], window=c["window"])


def run_decode(fn, c, **kw):
    return fn(c["q"], c["k"], c["v"], c["cache_len"], c["positions"],
              window=c["window"], **kw)


def run_decode_splits(c, n_splits):
    """B2's kernel at a forced split count (None: the wrapper's rule)."""
    if n_splits is None:
        return run_decode(decode_attention_bhd, c)
    return run_decode(launch_decode, c, n_splits=n_splits)


def run_decode_splits_lse(c, n_splits):
    """``run_decode_splits`` returning (out, lse)."""
    if n_splits is None:
        return run_decode(decode_attention_bhd, c, with_lse=True)
    return run_decode(launch_decode, c, n_splits=n_splits, with_lse=True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _check(kind, got, want, dtype_name):
    torch.testing.assert_close(got.float(), want.float(),
                               **KERNEL_TOLS[kind][dtype_name])


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
    _check("flash", got, run_flash(flash_attention_reference, c), dtype)


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
    _check("decode", got, run_decode(decode_attention_reference, c), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window", (None, 16))
def test_kernels_read_the_model_layouts(cuda_device, dtype, window):
    c = model_flash(cuda_device, DTYPES[dtype], window=window)
    got = run_flash(flash_attention_bhsd, c)
    assert got.shape == c["q"].shape
    _check("flash", got, run_flash(flash_attention_reference, c), dtype)
    c = model_decode(cuda_device, DTYPES[dtype], window=window)
    got = run_decode(decode_attention_bhd, c)
    torch.cuda.synchronize()
    _check("decode", got, run_decode(decode_attention_reference, c), dtype)


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
    _check("flash", got, run_flash(flash_attention_reference, c), dtype)
    for valid in (513, 544):
        c = model_path_decode(cuda_device, DTYPES[dtype], valid, H=H, KV=KV)
        got = run_decode(decode_attention_bhd, c)
        torch.cuda.synchronize()
        _check("decode", got, run_decode(decode_attention_reference, c), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernels_at_whisper_shapes(cuda_device, dtype):
    """B3 over whisper's 1,500 encoder frames, bidirectional (bf16 on the
    tensor-core route), and B2 over its 1,500 cross-attention slots."""
    c = whisper_flash(cuda_device, DTYPES[dtype])
    before = dict(flash_attention_bhsd.launches_by_route)
    got = run_flash(flash_attention_bhsd, c)
    torch.cuda.synchronize()
    if dtype == "bfloat16":
        assert flash_attention_bhsd.launches_by_route["wgmma"] == \
            before["wgmma"] + 1
    _check("flash", got, run_flash(flash_attention_reference, c), dtype)
    c = whisper_cross_decode(cuda_device, DTYPES[dtype])
    got = run_decode(decode_attention_bhd, c)
    torch.cuda.synchronize()
    _check("decode", got, run_decode(decode_attention_reference, c), dtype)


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


@pytest.mark.cuda
@pytest.mark.parametrize("name,params", wgmma_flash_cases(),
                         ids=[n for n, _ in wgmma_flash_cases()])
def test_flash_wgmma_route_matches_plain_version(cuda_device, name, params):
    c = wgmma_flash(cuda_device, **params)
    before = dict(flash_attention_bhsd.launches_by_route)
    got = run_flash(flash_attention_bhsd, c)
    torch.cuda.synchronize()
    assert flash_attention_bhsd.launches_by_route["wgmma"] == \
        before["wgmma"] + 1
    assert got.shape == c["q"].shape
    _check("flash", got, run_flash(flash_attention_reference, c), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,case,n_splits", split_decode_cases(),
                         ids=[n for n, _, _ in split_decode_cases()])
def test_decode_split_matches_plain_version(cuda_device, dtype, name, case,
                                            n_splits):
    c = to_torch(case, cuda_device, DTYPES[dtype])
    got = run_decode_splits(c, n_splits)
    torch.cuda.synchronize()
    _check("decode", got, run_decode(decode_attention_reference, c), dtype)
    if case["cache_len"][-1] == 0:        # no kept slot: the mean of V
        H, KV = c["q"].shape[1], c["k"].shape[1]
        mean = c["v"][-1].float().mean(1)            # [KV, D]
        _check("decode", got[-1], mean.repeat_interleave(H // KV, 0), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,case,n_splits", split_decode_cases(),
                         ids=[n for n, _, _ in split_decode_cases()])
def test_decode_lse_matches_plain_version(cuda_device, dtype, name, case,
                                          n_splits):
    """B2's log-sum-exp, written by the block that writes each row (one
    split, or the last of several), against the plain version's; the
    output is the one the call without it gives, bit for bit."""
    c = to_torch(case, cuda_device, DTYPES[dtype])
    out, lse = run_decode_splits_lse(c, n_splits)
    torch.cuda.synchronize()
    assert torch.equal(out, run_decode_splits(c, n_splits))
    want_out, want = run_decode(decode_attention_reference, c, with_lse=True)
    _check("decode", out, want_out, dtype)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    torch.testing.assert_close(lse, want, **KERNEL_TOLS["decode"][dtype])
    if case["cache_len"][-1] == 0:        # no kept slot: -1e30 + ln S
        assert (lse[-1] == -1e30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernels_are_deterministic(cuda_device, dtype):
    """Two calls on the same inputs give bitwise-equal outputs: B3 on each
    route, B2 merging many splits (in split order, not arrival order)."""
    c = model_flash(cuda_device, DTYPES[dtype], B=4, S=512)
    a, b = (run_flash(flash_attention_bhsd, c) for _ in range(2))
    assert torch.equal(a, b)
    name, case, _ = split_decode_cases()[4]
    c = to_torch(case, cuda_device, DTYPES[dtype])
    a, b = (run_decode_splits(c, 16) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,want", [
    ("bfloat16", 64, "wgmma"), ("bfloat16", 128, "wgmma"),
    ("bfloat16", 32, "simt"), ("float32", 64, "simt"),
    ("float32", 128, "simt")])
def test_flash_route_counter(cuda_device, dtype, D, want):
    c = model_flash(cuda_device, DTYPES[dtype], S=70, D=D)
    before = dict(flash_attention_bhsd.launches_by_route)
    run_flash(flash_attention_bhsd, c)
    after = flash_attention_bhsd.launches_by_route
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == want) for k in after}


@pytest.mark.cuda
def test_decode_tile_slots_match_the_kernel(cuda_device):
    from repro_torch.kernels._build import load_library
    lib = load_library()
    for dname, dtype in DTYPES.items():
        for D in (16, 32, 64, 128, 256):
            assert lib.da_tile_slots(int(dtype == torch.bfloat16), D) == \
                tile_slots(dtype, D), (dname, D)
