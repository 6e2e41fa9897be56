"""The published Mamba-2's chunked SSD kernel on the card against the plain
version (``models.ssm.ssd_reference``) and a float64 evaluation of it.

These tests need the card (marker ``cuda``) and skip without one.  They
import neither JAX nor ``repro``, so that they run where only the port is
installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_ssd_cuda.py

Inputs are laid out as ``mamba2_block`` hands them over: x, B and C are
slices of one [B, S, nh * 64 + 2 G * 128] tensor (the conv's output), in
bf16, the only type the kernel takes; dt is a softplus of a bias drawn as
Mamba-2 draws it plus noise, A = -uniform[1, 16].  The float64 evaluation
runs ``ssd_reference`` on the same values widened to float64 (exact).
Accuracy: the kernel's largest error in y relative to max |y64|, and in
h_last relative to max |h64|, must be at most ``AS_ACCURATE`` = 2 times the
plain float32 path's on the same inputs, with TF32 off (the plain path's
products then run in full float32).  Cases: chunk 256 and 64; S a
multiple of the chunk, a ragged tail, and S shorter than one chunk; with
and without h0; one group and two; and one layer at gen-hybrid-16k's
shape (4 x 16,384, 128 heads of 64, d_state 128, one group, chunk 256).

Also: the wrapper refuses what ``takes`` refuses, float32 inputs among
them, its launch count rises by one a call, and a bf16 ``mamba2_block`` on
the card takes the kernel for every call
(``MAMBA2_COUNTS["kernel_calls"]`` rises with ``"calls"``): the SSD's y
and h_last, on the inputs the block hands it, hold the rule above, and
the block's output lies within ``BF16_STEPS`` bf16 steps of its largest
value of the same block with the plain SSD.
"""
from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.base import Mamba2Config
from repro_torch.kernels import ssd as K
from repro_torch.models import ssm as TS

AS_ACCURATE = 2.0
BF16_STEPS = 2
HD, N = K.HEAD_DIM, K.D_STATE


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the card path has no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def ssd_inputs(device, B: int, S: int, nh: int, G: int, *, h0: bool,
               seed: int = 0) -> dict:
    """The SSD's inputs as ``mamba2_block`` passes them (module
    docstring)."""
    g = torch.Generator(device).manual_seed(seed)
    xbc = torch.randn((B, S, nh * HD + 2 * G * N), generator=g,
                      device=device).to(torch.bfloat16)
    x, b, c = xbc.split([nh * HD, G * N, G * N], dim=-1)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt0 = torch.exp(lo + (hi - lo) * torch.rand(nh, generator=g,
                                                device=device))
    bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = F.softplus(0.5 * torch.randn((B, S, nh), generator=g, device=device)
                    + bias)
    A = -(1 + 15 * torch.rand(nh, generator=g, device=device))
    return {"x": x.reshape(B, S, nh, HD), "dt": dt, "A": A,
            "Bg": b.view(B, S, G, N), "Cg": c.view(B, S, G, N),
            "h0": (0.1 * torch.randn((B, nh, HD, N), generator=g,
                                     device=device)) if h0 else None}


def wide(inputs: dict) -> dict:
    return {k: None if v is None else v.double() for k, v in inputs.items()}


def relative_errors(inputs: dict, chunk: int) -> dict:
    """Largest error of the kernel and of the plain float32 path against
    the float64 evaluation, in y over max |y64| and in h_last over max
    |h64|."""
    y, h = K.ssd_chunk(**inputs, chunk=chunk)
    y32, h32 = TS.ssd_reference(**inputs, chunk=chunk)
    y64, h64 = TS.ssd_reference(**wide(inputs), chunk=chunk)
    torch.cuda.synchronize()

    def rel(got, want):
        return ((got.double() - want).abs().max()
                / want.abs().max()).item()
    return {"kernel_y": rel(y, y64), "plain_y": rel(y32, y64),
            "kernel_h": rel(h, h64), "plain_h": rel(h32, h64)}


def assert_as_accurate(err: dict) -> None:
    for part in ("y", "h"):
        assert err[f"kernel_{part}"] <= AS_ACCURATE * err[f"plain_{part}"], \
            err


CASES = {
    # name: (B, S, nh, G, chunk, h0)
    "chunk256": (2, 512, 8, 1, 256, False),
    "chunk256_h0_ragged": (1, 300, 4, 1, 256, True),
    "chunk64_groups2_h0": (2, 256, 8, 2, 64, True),
    "chunk64_groups2_ragged": (2, 200, 8, 2, 64, False),
    "shorter_than_a_chunk": (1, 40, 4, 1, 64, True),
    "chunk128_groups2_h0": (1, 192, 8, 2, 128, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_is_as_accurate_as_the_plain_path(cuda_device, no_tf32, name):
    B, S, nh, G, chunk, h0 = CASES[name]
    inputs = ssd_inputs(cuda_device, B, S, nh, G, h0=h0, seed=len(name))
    assert K.takes(HD, N, nh, G, chunk, torch.bfloat16)
    assert_as_accurate(relative_errors(inputs, chunk))


@pytest.mark.cuda
def test_kernel_at_the_cells_shape(cuda_device, no_tf32):
    """One layer of gen-hybrid-16k's prefill: 4 x 16,384, 128 heads."""
    inputs = ssd_inputs(cuda_device, 4, 16384, 128, 1, h0=False, seed=28)
    assert_as_accurate(relative_errors(inputs, 256))


@pytest.mark.cuda
def test_wrapper_refuses_what_takes_refuses(cuda_device):
    for nh, G, chunk, hd, dtype in ((6, 1, 256, HD, torch.bfloat16),
                                    (8, 4, 256, HD, torch.bfloat16),
                                    (8, 1, 96, HD, torch.bfloat16),
                                    (8, 1, 512, HD, torch.bfloat16),
                                    (8, 1, 256, 32, torch.bfloat16),
                                    (8, 1, 256, HD, torch.float32)):
        assert not K.takes(hd, N, nh, G, chunk, dtype)
        x = torch.zeros((1, 64, nh, hd), dtype=dtype, device=cuda_device)
        bc = torch.zeros((1, 64, G, N), dtype=dtype, device=cuda_device)
        dt = torch.zeros((1, 64, nh), device=cuda_device)
        with pytest.raises(TypeError if dtype != K.DTYPE else ValueError):
            K.ssd_chunk(x, dt, torch.zeros(nh, device=cuda_device), bc, bc,
                        chunk)


@pytest.mark.cuda
def test_launch_count_rises_by_one_a_call(cuda_device):
    inputs = ssd_inputs(cuda_device, 1, 128, 4, 1, h0=False)
    before = K.ssd_chunk.launches
    K.ssd_chunk(**inputs, chunk=64)
    K.ssd_chunk(**inputs, chunk=64)
    assert K.ssd_chunk.launches - before == 2


@pytest.mark.cuda
def test_mamba2_block_takes_the_kernel_and_is_as_accurate(cuda_device,
                                                          no_tf32,
                                                          monkeypatch):
    """A bf16 block (two groups, chunk 64, a ragged tail) on the card."""
    dims = TS.ssm_dims(Mamba2Config(version=2, d_state=N, d_conv=4,
                                    expand=2, head_dim=HD, chunk=64,
                                    n_groups=2), 256)
    blk = TS.Mamba2(dims, 1e-5, torch.bfloat16, "cpu",
                    torch.Generator().manual_seed(3)).to(cuda_device)
    x = torch.randn((2, 150, 256), generator=torch.Generator().manual_seed(4)
                    ).to(cuda_device, torch.bfloat16)
    seen, kernel = [], TS.ssd

    def recorded(*args):
        seen.append(args)
        return kernel(*args)

    monkeypatch.setattr(TS, "ssd", recorded)
    with torch.no_grad():
        before = dict(TS.MAMBA2_COUNTS)
        got, _ = blk(x)
        rise = {k: TS.MAMBA2_COUNTS[k] - before[k] for k in before}
        monkeypatch.setattr(TS, "ssd", TS.ssd_reference)
        want, _ = blk(x)
        torch.cuda.synchronize()
    assert rise["calls"] == rise["kernel_calls"] == 1, rise
    (xh, dt, A, Bg, Cg, chunk, h0), = seen
    assert xh.dtype == Bg.dtype == Cg.dtype == torch.bfloat16
    assert_as_accurate(relative_errors(
        {"x": xh, "dt": dt, "A": A, "Bg": Bg, "Cg": Cg, "h0": h0}, chunk))
    step = 2.0 ** -7 * want.float().abs().max()
    assert (got.float() - want.float()).abs().max() <= BF16_STEPS * step
