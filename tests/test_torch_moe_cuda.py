"""The Mixture-of-Experts path on the card against the CPU, and its
repeatability.

These tests need the card (marker ``cuda``) and skip without one.  They
import neither JAX nor ``repro``, so that they run where only the port is
installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_moe_cuda.py

* ``moe_apply`` at granite-moe-3b-a800m's full width (d_model 1536, 40
  experts top-8, d_ff 512) over 64 tokens, float32 with TF32 off, the same
  weights and inputs on the card and on the CPU, under the near-tie rule
  (``routing_report``): where a token's expert set differs between the
  devices, that is a failure unless the CPU's probabilities at the top-k
  boundary (the k-th and (k+1)-th largest) are within ``NEAR_TIE`` = 1e-5
  of each other; such a near-tie is counted, and a run that has one
  proves nothing about the outputs (a flipped token moves others in their
  buckets).  Up to three input seeds are tried; the first without a
  near-tie must give outputs within atol = rtol = 1e-4 (float32 sums in
  another order, over 8 experts of 512) and an equal aux loss within
  1e-5.  Every seed is reported.
* The combine (gather and sum, no atomics) and the whole of
  ``moe_apply`` in bf16 at granite's prefill shape (8 x 512 tokens:
  capacity 1,028) give bitwise-equal outputs on two calls.
* ``moe_apply`` makes no host sync on the card
  (``torch.cuda.set_sync_debug_mode("error")``), so that a decode loop
  stays on the device.

``routing_report`` also serves ``chip_smoke.py``'s phase 24.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import moe as TMoE

NEAR_TIE = 1e-5
SEEDS = (0, 1, 2)


def routing_report(x_card, x_cpu, router_card, router_cpu, dims) -> dict:
    """Compare the expert sets a router picks for the same tokens on the
    card and on the CPU.  Returns {"tokens", "differ", "near_ties",
    "min_gap"}: the tokens compared, those whose sets differ, those of
    them at a near-tie (the CPU's k-th and (k+1)-th probabilities within
    ``NEAR_TIE``) and the smallest such gap over the differing tokens.
    ``differ > near_ties`` breaks the rule."""
    k = dims.top_k
    probs = TMoE.router_probs(router_cpu, x_cpu.reshape(-1, x_cpu.shape[-1]),
                              dims)
    top = torch.topk(probs, k + 1, dim=-1).values
    gap = top[:, k - 1] - top[:, k]
    want = torch.topk(probs, k, dim=-1).indices.sort(-1).values
    got = torch.topk(TMoE.router_probs(
        router_card, x_card.reshape(-1, x_card.shape[-1]), dims), k,
        dim=-1).indices.sort(-1).values.cpu()
    differ = (got != want).any(-1)
    near = differ & (gap <= NEAR_TIE)
    return {"tokens": int(differ.numel()), "differ": int(differ.sum()),
            "near_ties": int(near.sum()),
            "min_gap": float(gap[differ].min()) if differ.any() else None}


def granite_dims():
    cfg = get_config("granite-moe-3b-a800m")
    return TMoE.moe_dims(cfg.moe, cfg.d_model)


def granite_experts(device, dtype, seed: int = 0) -> TMoE.MoE:
    return TMoE.MoE(granite_dims(), dtype, device,
                    torch.Generator(device).manual_seed(seed))


def params_of(layer: TMoE.MoE) -> dict:
    return dict(layer.named_parameters())


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


@pytest.mark.cuda
def test_moe_apply_on_card_matches_cpu_under_the_near_tie_rule(cuda_device,
                                                               no_tf32):
    cpu = granite_experts("cpu", torch.float32)
    dims = cpu.dims
    card = {n: p.detach().to(cuda_device) for n, p in params_of(cpu).items()}
    reports = []
    for seed in SEEDS:
        x = torch.randn((2, 32, dims.d_model),
                        generator=torch.Generator().manual_seed(seed))
        with torch.no_grad():
            y_cpu, aux_cpu = TMoE.moe_apply(params_of(cpu), x, dims)
            y_card, aux_card = TMoE.moe_apply(card, x.to(cuda_device), dims)
        rep = routing_report(x.to(cuda_device), x, card["router"],
                             cpu.router.detach(), dims)
        reports.append((seed, rep))
        assert rep["differ"] == rep["near_ties"], reports
        if rep["near_ties"]:
            continue
        torch.testing.assert_close(y_card.cpu(), y_cpu, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(aux_card.cpu(), aux_cpu, atol=1e-5,
                                   rtol=1e-5)
        return
    pytest.fail(f"every seed had a near-tie: {reports}")


@pytest.mark.cuda
def test_combine_and_moe_apply_repeat_bitwise_on_card(cuda_device):
    dims = granite_dims()
    N = 8 * 512
    C = TMoE._capacity(N, dims)
    assert C == 1028
    g = torch.Generator(cuda_device).manual_seed(3)
    x = torch.randn((N, dims.d_model), generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    layer = granite_experts(cuda_device, torch.bfloat16, seed=1)
    with torch.no_grad():
        gates, idx, _ = TMoE._route(layer.router, x, dims)
        xe, ge, tok = TMoE._bucket(x, gates, idx, C, dims)
        y_e = TMoE._expert_ffn(layer.w_gate, layer.w_up, layer.w_down, xe)
        a, b = (TMoE._combine(y_e, ge, tok, N, dims.d_model, dims.top_k)
                for _ in range(2))
        assert torch.equal(a, b)
        (ya, auxa), (yb, auxb) = (layer(x.reshape(8, 512, -1))
                                  for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(ya, yb) and torch.equal(auxa, auxb)
    assert torch.equal(ya.reshape(N, -1), a)


@pytest.mark.cuda
def test_moe_apply_makes_no_host_sync(cuda_device):
    layer = granite_experts(cuda_device, torch.bfloat16)
    x = torch.randn((8, 1, layer.dims.d_model), device=cuda_device,
                    dtype=torch.bfloat16)
    with torch.no_grad():
        layer(x)                                     # warm-up, allocations
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, _ = layer(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
