"""The CUDA kernel of the Mamba-1 selective scan (B4) against its plain
version, on the card.

These tests need the card (marker ``cuda``) and skip without one.  They
import neither JAX nor ``repro``, so that they run where only the port is
installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_mamba_scan_cuda.py

The cases: tests/test_kernels.py's three shapes, a ragged channel count
(not a multiple of the kernel's 128-channel block), nonzero initial states,
d_state 32 and 64, and falcon-mamba-7b's width (8 sequences, d_inner 8192,
d_state 16) at T = 1 from a carried state (a decode step) and at T = 512
(the prefill); h_last written over h0, as a decode step writes it, at
falcon-mamba-7b's width too.  For
the kernel's design: every d_state with its lanes per channel (N / 8) at T
= 1, 15, 17 and 40 (the tiles are 16 steps), h_last over h0 at every
d_state with 16-byte and 4-byte copies, and bitwise-equal repeated
calls.  Both
``y`` and ``h_last`` are compared, float32, atol =
rtol = 1e-4 (tests/test_kernels.py's tolerance for this kernel).  The
case functions below also feed tests/test_torch_mamba_scan.py (the plain
version against the JAX package on the CPU) and ``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba_scan import (
    mamba1_scan,
    mamba1_scan_reference,
)

TOL = dict(atol=1e-4, rtol=1e-4)
# (B, T, Di, N, with h0): tests/test_kernels.py's three, then a ragged Di,
# nonzero initial states, and d_state 32 and 64
SHAPES = [(2, 64, 256, 16, False), (1, 128, 512, 8, False),
          (3, 32, 128, 16, False), (2, 40, 200, 16, False),
          (2, 33, 384, 8, True), (1, 50, 256, 32, True),
          (2, 20, 130, 64, True)]
FALCON = dict(B=8, Di=8192, N=16)           # falcon-mamba-7b's scan width


def scan_case(B, T, Di, N, with_h0, seed=0) -> dict:
    """Numpy inputs of one B4 call, float32, drawn as tests/test_kernels.py
    draws them: x and B_t, C_t normal, dt = softplus(normal), A =
    -exp(0.3 normal); h0 normal or None."""
    rng = np.random.default_rng(seed + 1000 * N + 7 * T + Di + B)
    f32 = np.float32
    return dict(
        x=rng.standard_normal((B, T, Di)).astype(f32),
        dt=np.logaddexp(0.0, rng.standard_normal((B, T, Di))).astype(f32),
        Bt=rng.standard_normal((B, T, N)).astype(f32),
        Ct=rng.standard_normal((B, T, N)).astype(f32),
        A=(-np.exp(0.3 * rng.standard_normal((Di, N)))).astype(f32),
        h0=(rng.standard_normal((B, Di, N)).astype(f32) if with_h0
            else None))


def shape_id(shape) -> str:
    B, T, Di, N, with_h0 = shape
    return f"B{B}-T{T}-Di{Di}-N{N}" + ("-h0" if with_h0 else "")


def to_torch(case: dict, device) -> dict:
    return {k: None if v is None else torch.from_numpy(v).to(device)
            for k, v in case.items()}


def falcon_case(device, T: int, *, with_h0: bool, seed: int = 0) -> dict:
    """B4's inputs at falcon-mamba-7b's width, drawn on ``device`` from a
    ``torch.Generator`` (T = 512 is 134 MB per [B, T, Di] tensor)."""
    B, Di, N = FALCON["B"], FALCON["Di"], FALCON["N"]
    g = torch.Generator(device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)
    return dict(x=normal(B, T, Di),
                dt=torch.nn.functional.softplus(normal(B, T, Di)),
                Bt=normal(B, T, N), Ct=normal(B, T, N),
                A=-torch.exp(0.3 * normal(Di, N)),
                h0=normal(B, Di, N) if with_h0 else None)


def run(fn, c):
    return fn(c["x"], c["dt"], c["Bt"], c["Ct"], c["A"], c["h0"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _check_against_plain(c):
    before = mamba1_scan.launches
    y, h = run(mamba1_scan, c)
    torch.cuda.synchronize()
    assert mamba1_scan.launches == before + 1
    y_want, h_want = run(mamba1_scan_reference, c)
    torch.testing.assert_close(y, y_want, **TOL)
    torch.testing.assert_close(h, h_want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=[shape_id(s) for s in SHAPES])
def test_scan_kernel_matches_plain_version(cuda_device, shape):
    _check_against_plain(to_torch(scan_case(*shape), cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("T,with_h0", [(1, True), (512, False)],
                         ids=["decode-T1-h0", "prefill-T512"])
def test_scan_kernel_at_falcon_mamba_width(cuda_device, T, with_h0):
    _check_against_plain(falcon_case(cuda_device, T, with_h0=with_h0))


@pytest.mark.cuda
def test_scan_kernel_takes_strided_projections(cuda_device):
    """B_t and C_t as the model passes them: float32 copies of slices of
    one [B, T, rank + 2N] projection."""
    c = to_torch(scan_case(2, 24, 256, 16, True), cuda_device)
    xbc = torch.cat([torch.zeros_like(c["Bt"][..., :5]), c["Bt"], c["Ct"]],
                    dim=-1)
    c["Bt"], c["Ct"] = xbc[..., 5:21], xbc[..., 21:]
    _check_against_plain(c)


@pytest.mark.cuda
@pytest.mark.parametrize("T,falcon", [(1, False), (33, False), (1, True)],
                         ids=["1", "33", "falcon-1"])
def test_scan_kernel_writes_the_state_in_place(cuda_device, T, falcon):
    """h_last written over h0, as a decode step advances its cache entry
    (T = 1, and at falcon-mamba-7b's width), and over a longer run: each
    thread reads its state before it writes it."""
    c = (falcon_case(cuda_device, T, with_h0=True, seed=2) if falcon
         else to_torch(scan_case(2, T, 200, 16, True), cuda_device))
    y_want, h_want = run(mamba1_scan_reference, c)
    h0 = c["h0"].clone()
    before = mamba1_scan.launches
    y, h = mamba1_scan(c["x"], c["dt"], c["Bt"], c["Ct"], c["A"], h0, h0)
    torch.cuda.synchronize()
    assert mamba1_scan.launches == before + 1
    assert h is h0
    torch.testing.assert_close(y, y_want, **TOL)
    torch.testing.assert_close(h, h_want, **TOL)


@pytest.mark.cuda
def test_scan_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    c = to_torch(scan_case(1, 8, 128, 8, True), cuda_device)
    with pytest.raises(TypeError):                       # bf16 x
        mamba1_scan(c["x"].bfloat16(), c["dt"], c["Bt"], c["Ct"], c["A"])
    bad = torch.zeros(1, 8, 12, device=cuda_device)      # N 12 is not built
    with pytest.raises(ValueError):
        mamba1_scan(c["x"], c["dt"], bad, bad, torch.zeros(128, 12,
                                                           device=cuda_device))
    with pytest.raises(ValueError):                      # h0 of another shape
        mamba1_scan(c["x"], c["dt"], c["Bt"], c["Ct"], c["A"], c["h0"][:, :64])


# lanes per channel: N / 8 (1, 2, 4, 8); tiles of 16 steps
STATE_CASES = [(N, T) for N in (8, 16, 32, 64) for T in (1, 15, 17, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,T", STATE_CASES,
                         ids=[f"N{N}-T{T}" for N, T in STATE_CASES])
def test_scan_kernel_each_state_size(cuda_device, N, T):
    """Each d_state with its lanes per channel, at T = 1 and at T on
    either side of the 16-step tile and not a multiple of it; a channel
    count that is not a multiple of any block's (200), from a state."""
    _check_against_plain(to_torch(scan_case(2, T, 200, N, True),
                                  cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("N", (8, 16, 32, 64))
@pytest.mark.parametrize("Di", (256, 130))
def test_scan_kernel_state_in_place_each_size(cuda_device, N, Di):
    """h_last written over h0 at every d_state, with 16-byte rows (Di 256)
    and with 4-byte copies (Di 130 is not a multiple of 4)."""
    c = to_torch(scan_case(3, 1, Di, N, True, seed=5), cuda_device)
    y_want, h_want = run(mamba1_scan_reference, c)
    h0 = c["h0"].clone()
    y, h = mamba1_scan(c["x"], c["dt"], c["Bt"], c["Ct"], c["A"], h0, h0)
    torch.cuda.synchronize()
    assert h is h0
    torch.testing.assert_close(y, y_want, **TOL)
    torch.testing.assert_close(h, h_want, **TOL)


@pytest.mark.cuda
def test_scan_kernel_repeats_bitwise(cuda_device):
    c = falcon_case(cuda_device, 40, with_h0=True)
    first = run(mamba1_scan, c)
    for _ in range(2):
        for a, b in zip(run(mamba1_scan, c), first):
            assert torch.equal(a, b)
