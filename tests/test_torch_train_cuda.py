"""The backward kernels of B3 (flash attention) and B4 (the Mamba-1 scan)
against their plain versions, and one training step on the card against
the CPU.

These tests need the card (marker ``cuda``) and skip without one.  They
import neither JAX nor ``repro``, so that they run where only the port is
installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_train_cuda.py

B3's backward (``flash_attention_bwd``, two kernels) is held to
``flash_attention_bwd_reference`` on the same inputs (q, k, v, and the
kernel forward's own output and log-sum-exp), the whole ``FlashAttentionFn``
to ``torch.autograd`` of the plain forward, and the forward's ``lse`` to
the plain log-sum-exp.  Cases: tests/test_kernels.py's (through
tests/test_torch_attention_cuda.py's ``flash_cases``), then every head
dim (16 to 256) at S = 1, 17 and 512 with causal, bidirectional and
window-16 masks, GQA groups of 1, 7 and 48 (granite-20b's MQA) and batches
of 1 and 3, through the model's [B, S, H, D] views with a ``grad_output``
of its own strides (a slice of a wider tensor, or one whose last stride is
not 1); whisper-small's encoder (8 x 1,500 frames, bidirectional, 12/12
heads at D 64).  Tolerances (``BWD_TOLS``): float32 atol = rtol = 1e-4;
bfloat16 rtol 2e-2 with B3's bf16 atol (8e-3, tests/test_torch_attention_
cuda.py's ``KERNEL_TOLS``) against the plain backward on the same inputs,
and against autograd of the plain forward (whose probabilities are not
rounded to the kernel forward's bf16 output) with the atol scaled to each
gradient's largest magnitude.

B4's backward (``mamba1_scan_bwd``) is held to ``mamba1_scan_bwd_reference``
and ``MambaScanFn`` to ``torch.autograd`` of ``mamba1_scan_reference``,
float32, on tests/test_torch_mamba_scan_cuda.py's shapes (nonzero initial
states among them, with a gradient for h0 and for h_last), every d_state
at T = 1, 15, 17, 40 and 512, and falcon-mamba-7b's width (8 x 512 x 8192
channels x 16 states).  ``SCAN_TOL``: rtol 1e-4, with an atol of 1e-4
times each gradient's largest magnitude: dB, dC and dA are sums over
thousands of channels and steps whose float32 rounding grows with the
terms, not with the (possibly cancelled) sum.

Both must give bitwise-equal gradients on two calls (no atomics).

Three train steps of qwen2-0.5b and falcon-mamba-7b on the card against
the CPU, float32 with TF32 off, from the same weights and batches: at the
tiny configs and at every width as published cut to two layers.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (
    HEAD_DIMS,
    FlashAttentionFn,
    bwd_route,
    flash_attention_bhsd,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_lse_reference,
    flash_attention_reference,
)
from repro_torch.kernels.mamba_scan import (
    STATE_SIZES,
    MambaScanFn,
    mamba1_scan,
    mamba1_scan_bwd,
    mamba1_scan_bwd_reference,
    mamba1_scan_reference,
    n_checkpoints,
)

import test_torch_attention_cuda as attn_cases
import test_torch_mamba_scan_cuda as scan_cases

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BWD_TOLS = {"float32": dict(atol=1e-4, rtol=1e-4),
            "bfloat16": dict(atol=8e-3, rtol=2e-2)}
SCAN_TOL = dict(atol=1e-4, rtol=1e-4)       # atol scaled by max |plain|
LSE_TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
           "bfloat16": dict(atol=1e-3, rtol=1e-4)}

# ---------------------------------------------------------------------------
# B3's backward: cases
# ---------------------------------------------------------------------------

BWD_SEQS = (1, 17, 512)
BWD_MASKS = {"causal": (True, None), "bidir": (False, None),
             "w16": (True, 16)}


def flash_bwd_cases():
    """[(id, params)] for ``flash_bwd_case``: every head dim, S 1/17/512,
    the three masks, the GQA group cycling through (1, 7, 48) and the batch
    through (1, 3), the grad_output's layout through its two kinds."""
    out = []
    for D in HEAD_DIMS:
        for S in BWD_SEQS:
            for mask in BWD_MASKS:
                i = len(out)
                r, B = (1, 7, 48)[i % 3], (1, 3)[i % 2]
                out.append((f"D{D}-S{S}-{mask}-r{r}-B{B}",
                            dict(D=D, S=S, mask=mask, r=r, B=B,
                                 do_layout=("slice", "transposed")[i % 2])))
    return out


def _grad_output(shape, device, dtype, layout: str, g):
    """A [B, H, S, D] gradient of its own strides: a slice of a tensor
    twice as wide (last stride 1, rows 2 D apart) or a transposed [B, H, D,
    S] tensor (last stride S: the wrapper makes it contiguous)."""
    B, H, S, D = shape
    if layout == "slice":
        return torch.randn((B, H, S, 2 * D), generator=g).to(
            device, dtype)[..., :D]
    return torch.randn((B, H, D, S), generator=g).to(
        device, dtype).transpose(-1, -2)


def flash_bwd_case(device, dtype, *, D, S, mask, r, B, do_layout="slice",
                   KV=None, seed=0) -> dict:
    """q, k, v as the model passes them ([B, H, S, D] views of [B, S, H, D]
    activations), a grad_output ``do`` of other strides; r 48 with KV 1
    (granite-20b's MQA), else KV 2 unless given."""
    KV = KV or (1 if r == 48 else 2)
    causal, window = BWD_MASKS[mask]
    c = attn_cases.model_flash(device, dtype, B=B, S=S, H=r * KV, KV=KV, D=D,
                               window=window)
    c["causal"] = causal
    g = torch.Generator().manual_seed(seed + 17 * S + D)
    c["do"] = _grad_output(tuple(c["q"].shape), device, dtype, do_layout, g)
    return c


def whisper_bwd_case(device, dtype) -> dict:
    """B3's backward at whisper-small's encoder: 8 x 1,500 frames,
    bidirectional, 12/12 heads at D 64."""
    w = attn_cases.WHISPER
    return flash_bwd_case(device, dtype, D=w["D"], S=w["T"], mask="bidir",
                          r=w["H"] // w["KV"], B=w["B"], KV=w["KV"])


def numpy_bwd_case(case, device, dtype, seed=3) -> dict:
    """A tests/test_kernels.py case ([BH, S, D] numpy) with a grad_output."""
    c = attn_cases.to_torch(case, device, dtype)
    rng = np.random.default_rng(seed)
    c["do"] = torch.from_numpy(rng.standard_normal(
        case["q"].shape).astype(np.float32)).to(device, dtype)
    return c


def run_flash_bwd(c) -> dict:
    """Everything B3's backward is held to on one case: the kernel
    forward's output and lse beside the plain lse, the kernel backward and
    the plain backward on the same (q, k, v, o, lse, do), and the whole
    ``FlashAttentionFn`` beside autograd of the plain forward."""
    q, k, v, do = c["q"], c["k"], c["v"], c["do"]
    kw = dict(causal=c["causal"], window=c["window"])
    o, lse = flash_attention_bhsd(q, k, v, with_lse=True, **kw)
    out = {"lse": (lse, flash_attention_lse_reference(q, k, **kw))}
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, kw["causal"],
                                         kw["window"])
    out["bwd"] = (got, want)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fn = torch.autograd.grad(
        FlashAttentionFn.apply(*leaves, kw["causal"], kw["window"]),
        leaves, do)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ag = torch.autograd.grad(flash_attention_reference(*leaves, **kw),
                             leaves, do)
    out["autograd"] = (fn, ag)
    return out


def flash_bwd_errors(c, dtype_name: str) -> dict:
    """Max abs error of each comparison of ``run_flash_bwd``; raises
    AssertionError outside the stated tolerances."""
    res = run_flash_bwd(c)
    tol = BWD_TOLS[dtype_name]
    errs = {}
    got, want = res["lse"]
    torch.testing.assert_close(got, want, **LSE_TOL[dtype_name])
    errs["lse"] = (got - want).abs().max().item()
    for what in ("bwd", "autograd"):
        for name, g, w in zip("qkv", *res[what]):
            assert g.shape == w.shape and g.dtype == w.dtype, (name, what)
            g, w = g.float(), w.float()
            t = dict(tol)
            if what == "autograd" and dtype_name == "bfloat16":
                t["atol"] = tol["atol"] * max(1.0, w.abs().max().item())
            torch.testing.assert_close(g, w, **t, msg=lambda m: (
                f"d{name} ({what}): {m}"))
            errs[f"d{name}-{what}"] = (g - w).abs().max().item()
    return errs


# ---------------------------------------------------------------------------
# B4's backward: cases
# ---------------------------------------------------------------------------

SCAN_BWD_STATES = [(N, T) for N in (8, 16, 32, 64)
                   for T in (1, 15, 17, 40, 512)]


def scan_bwd_case(c: dict, device, seed: int = 9) -> dict:
    """A B4 case with dy [B, T, Di] and dh_last [B, Di, N] drawn on
    ``device``."""
    g = torch.Generator(device).manual_seed(seed)
    c = dict(c)
    c["dy"] = torch.randn(c["x"].shape, generator=g, device=device)
    B, _, Di = c["x"].shape
    c["dh_last"] = torch.randn((B, Di, c["A"].shape[1]), generator=g,
                               device=device)
    return c


def scan_check(x, want, tol=SCAN_TOL) -> float:
    """assert_close with the atol scaled to the plain value's largest
    magnitude; returns the max abs error."""
    t = dict(tol, atol=tol["atol"] * max(1.0, want.abs().max().item()))
    torch.testing.assert_close(x, want, **t)
    return (x - want).abs().max().item()


def scan_bwd_errors(c) -> dict:
    """The kernel backward against the plain backward, and ``MambaScanFn``
    against autograd of the plain forward (h0's gradient when it is
    given, dh_last feeding the final state)."""
    args = [c[n] for n in ("x", "dt", "Bt", "Ct", "A", "h0")]
    names = ("dx", "ddt", "dB", "dC", "dA", "dh0")
    got = mamba1_scan_bwd(*args, c["dy"], c["dh_last"])
    want = mamba1_scan_bwd_reference(*args, c["dy"], c["dh_last"])
    errs = {}
    for n, g, w in zip(names, got, want):
        try:
            errs[n] = scan_check(g, w)
        except AssertionError as e:
            raise AssertionError(f"{n} (kernel vs plain backward): {e}")
    leaves = [None if a is None else a.detach().clone().requires_grad_()
              for a in args]
    live = [a for a in leaves if a is not None]
    fn = torch.autograd.grad(MambaScanFn.apply(*leaves), live,
                             (c["dy"], c["dh_last"]))
    leaves = [None if a is None else a.detach().clone().requires_grad_()
              for a in args]
    live = [a for a in leaves if a is not None]
    ag = torch.autograd.grad(mamba1_scan_reference(*leaves), live,
                             (c["dy"], c["dh_last"]))
    for n, g, w in zip(names, fn, ag):
        try:
            errs[f"{n}-autograd"] = scan_check(g, w)
        except AssertionError as e:
            raise AssertionError(f"{n} (Function vs autograd): {e}")
    return errs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,case", attn_cases.flash_cases(),
                         ids=[n for n, _ in attn_cases.flash_cases()])
def test_flash_bwd_at_the_kernel_test_shapes(cuda_device, dtype, name, case):
    c = numpy_bwd_case(case, cuda_device, DTYPES[dtype])
    before = flash_attention_bwd.launches
    flash_bwd_errors(c, dtype)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches >= before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,params", flash_bwd_cases(),
                         ids=[n for n, _ in flash_bwd_cases()])
def test_flash_bwd_matches_plain(cuda_device, dtype, name, params):
    flash_bwd_errors(flash_bwd_case(cuda_device, DTYPES[dtype], **params),
                     dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_bwd_at_whisper_encoder(cuda_device, dtype):
    flash_bwd_errors(whisper_bwd_case(cuda_device, DTYPES[dtype]), dtype)


@pytest.mark.cuda
def test_flash_bwd_gradients_come_back_in_the_model_layout(cuda_device):
    """dq, dk, dv have the views' shapes, laid out [B, S, heads, D]."""
    c = flash_bwd_case(cuda_device, torch.bfloat16, D=64, S=100,
                       mask="causal", r=7, B=2)
    o, lse = flash_attention_bhsd(c["q"], c["k"], c["v"], with_lse=True)
    for g, t in zip(flash_attention_bwd(c["q"], c["k"], c["v"], o, lse,
                                        c["do"]), (c["q"], c["k"], c["v"])):
        assert g.shape == t.shape
        assert g.transpose(1, 2).is_contiguous()


@pytest.mark.cuda
def test_flash_bwd_repeats_bitwise(cuda_device):
    c = flash_bwd_case(cuda_device, torch.bfloat16, D=64, S=512,
                       mask="causal", r=7, B=3)
    o, lse = flash_attention_bhsd(c["q"], c["k"], c["v"], with_lse=True)
    first = flash_attention_bwd(c["q"], c["k"], c["v"], o, lse, c["do"])
    again = flash_attention_bwd(c["q"], c["k"], c["v"], o, lse, c["do"])
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_flash_bwd_routes(cuda_device, dtype, D):
    """bf16 at D 64 and 128 takes the tensor-core kernels, every other
    (dtype, D) the CUDA-core ones; each call counts once on its route."""
    want = "wgmma" if dtype == "bfloat16" and D in (64, 128) else "simt"
    assert bwd_route(DTYPES[dtype], D) == want
    c = flash_bwd_case(cuda_device, DTYPES[dtype], D=D, S=40, mask="causal",
                       r=7, B=1)
    o, lse = flash_attention_bhsd(c["q"], c["k"], c["v"], with_lse=True)
    before = dict(flash_attention_bwd.launches_by_route)
    flash_attention_bwd(c["q"], c["k"], c["v"], o, lse, c["do"])
    torch.cuda.synchronize()
    after = flash_attention_bwd.launches_by_route
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == want) for r in after}


# (D, r, S, B): pairs per dK/dV block odd and even, a group of 48 over
# fewer query tiles than warpgroups, tails of S
WGMMA_SPLITS = [(64, 7, 512, 2), (64, 48, 100, 1), (128, 7, 200, 3),
                (128, 48, 17, 2), (64, 1, 1, 1), (128, 2, 64, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("D,r,S,B", WGMMA_SPLITS,
                         ids=[f"D{D}-r{r}-S{S}-B{B}"
                              for D, r, S, B in WGMMA_SPLITS])
@pytest.mark.parametrize("mask", sorted(BWD_MASKS))
def test_flash_bwd_wgmma_splits_the_gqa_group(cuda_device, D, r, S, B,
                                              mask):
    """The tensor-core dK/dV kernel shares a kv head's (query head, query
    tile) pairs among its warpgroups and adds their sums in a fixed order:
    held to the plain backward at every split, and bitwise equal on two
    calls."""
    c = flash_bwd_case(cuda_device, torch.bfloat16, D=D, S=S, mask=mask,
                       r=r, B=B, KV=1 if r == 48 else 2)
    before = flash_attention_bwd.launches_by_route["wgmma"]
    flash_bwd_errors(c, "bfloat16")
    kw = dict(causal=c["causal"], window=c["window"])
    o, lse = flash_attention_bhsd(c["q"], c["k"], c["v"], with_lse=True, **kw)
    first = flash_attention_bwd(c["q"], c["k"], c["v"], o, lse, c["do"], **kw)
    again = flash_attention_bwd(c["q"], c["k"], c["v"], o, lse, c["do"], **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    # the kernel backward, FlashAttentionFn's, and the two repeats
    assert flash_attention_bwd.launches_by_route["wgmma"] == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("N", STATE_SIZES)
@pytest.mark.parametrize("T", (1, 15, 17, 40))
def test_scan_checkpoints_match_the_plain_recurrence(cuda_device, N, T):
    """The forward kernel's checkpoints (the state before steps 0, 16, ...)
    against the plain recurrence's, from a state; y and h_last are those
    of the same call without checkpoints, bit for bit."""
    c = scan_cases.to_torch(scan_cases.scan_case(2, T, 200, N, True),
                            cuda_device)
    args = [c[n] for n in ("x", "dt", "Bt", "Ct", "A", "h0")]
    y, h, ckpt = mamba1_scan(*args, with_checkpoints=True)
    _, _, want = mamba1_scan_reference(*args, with_checkpoints=True)
    assert ckpt.shape == (2, n_checkpoints(T), 200, N)
    torch.testing.assert_close(ckpt, want, **scan_cases.TOL)
    assert torch.equal(ckpt[:, 0], c["h0"])
    y0, h0 = mamba1_scan(*args)
    assert torch.equal(y, y0) and torch.equal(h, h0)


def _scan_param(shape):
    return scan_cases.shape_id(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", scan_cases.SHAPES,
                         ids=[_scan_param(s) for s in scan_cases.SHAPES])
def test_scan_bwd_at_the_kernel_test_shapes(cuda_device, shape):
    c = scan_bwd_case(scan_cases.to_torch(scan_cases.scan_case(*shape),
                                          cuda_device), cuda_device)
    before = mamba1_scan_bwd.launches
    scan_bwd_errors(c)
    torch.cuda.synchronize()
    assert mamba1_scan_bwd.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("N,T", SCAN_BWD_STATES,
                         ids=[f"N{N}-T{T}" for N, T in SCAN_BWD_STATES])
def test_scan_bwd_each_state_size(cuda_device, N, T):
    """Every d_state at T on either side of the 16-step chunk and at 512,
    200 channels (no multiple of any block's), from a state."""
    c = scan_bwd_case(scan_cases.to_torch(
        scan_cases.scan_case(2, T, 200, N, True), cuda_device), cuda_device)
    scan_bwd_errors(c)


@pytest.mark.cuda
def test_scan_bwd_at_falcon_mamba_width(cuda_device):
    c = scan_bwd_case(scan_cases.falcon_case(cuda_device, 512,
                                             with_h0=False), cuda_device)
    scan_bwd_errors(c)


@pytest.mark.cuda
def test_scan_bwd_repeats_bitwise(cuda_device):
    c = scan_bwd_case(scan_cases.falcon_case(cuda_device, 40, with_h0=True),
                      cuda_device)
    args = [c[n] for n in ("x", "dt", "Bt", "Ct", "A", "h0")]
    first = mamba1_scan_bwd(*args, c["dy"], c["dh_last"])
    again = mamba1_scan_bwd(*args, c["dy"], c["dh_last"])
    for a, b in zip(first, again):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# one training step on the card against the CPU
# ---------------------------------------------------------------------------


def train_identity(arch: str, device, cfg=None, *, steps: int = 3,
                   batch: int = 2, seq: int = 64, seed: int = 0) -> list:
    """``steps`` train steps of ``arch`` (``cfg``: default its tiny
    config), float32, on the card and on the CPU from the same weights
    (drawn on the CPU) and the same numpy batches; returns per step the
    (card, CPU) metrics as floats.  TF32 is turned off for the run."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.launch.train import tiny_config
    from repro_torch.models.model import Model
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step

    cfg = cfg or tiny_config(get_config(arch))
    host = Model(cfg, generator=torch.Generator().manual_seed(seed),
                 device="cpu")
    card = copy.deepcopy(host).to(device)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1))
        batches.append({"tokens": toks[:, :-1].astype(np.int32),
                        "targets": toks[:, 1:].astype(np.int32)})
    ocfg = optim.AdamWConfig(warmup_steps=5, decay_steps=10)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = []
        for model in (card, host):
            dev = next(model.parameters()).device
            step = make_train_step(model, ocfg, remat=False, ce_chunks=2)
            state = optim.init_opt_state(dict(model.named_parameters()))
            rows = []
            for b in batches:
                state, m = step(state, {k: torch.from_numpy(v).to(dev)
                                        for k, v in b.items()})
                rows.append({k: float(v) for k, v in m.items()})
            out.append(rows)
            del model, state
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return list(zip(*out))


# step 1 from the same weights: float32 sums in other orders; steps 2 and
# 3 start from weights that AdamW moved, where an element whose gradient is
# near 0 moves by +-lr by the sign of a rounding error
IDENTITY_TOL = (1e-5, 1e-4, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n_layers", (None, 2),
                         ids=("tiny", "published-widths-2-layers"))
@pytest.mark.parametrize("arch", ("qwen2-0.5b", "falcon-mamba-7b"))
def test_train_steps_on_the_card_match_the_cpu(cuda_device, arch, n_layers):
    from repro_torch.configs import get_config
    cfg = (None if n_layers is None else
           get_config(arch).scaled(dtype="float32", n_layers=n_layers))
    before = (flash_attention_bwd.launches, mamba1_scan_bwd.launches)
    rows = train_identity(arch, cuda_device, cfg)
    after = (flash_attention_bwd.launches, mamba1_scan_bwd.launches)
    assert after[arch == "falcon-mamba-7b"] > before[arch == "falcon-mamba-7b"]
    for i, (card, host) in enumerate(rows):
        for k in ("loss", "ce", "grad_norm", "lr"):
            assert np.isfinite(card[k])
            assert card[k] == pytest.approx(host[k], rel=IDENTITY_TOL[i]), \
                (i, k)
