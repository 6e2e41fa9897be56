"""Multi-head latent attention (``models.mla``) on the card, at
DeepSeek-V2-Lite's widths.

These tests need the card (marker ``cuda``) and skip without one.  They
import neither JAX nor ``repro``:

    python -m pytest -q --noconftest -m cuda tests/test_torch_mla_cuda.py

* One MLA layer on the card against the same layer on the CPU, float32
  with TF32 off, the same weights and inputs: a decompressed prefill of 2
  x 256 tokens (its B3 call at the padded head dim 256 on the CUDA-core
  route) and 4 absorbed decode steps from its latent cache, outputs and
  caches within atol = rtol = 1e-4 (float32 sums in another order over
  2,048-wide products and 260 positions).
* The padded B3 call (``decompressed_attention``: q, k, v padded from
  192 / 192 / 128 to 256, q prescaled) against the plain attention over
  the unpadded heads, on the same card and inputs: float32 within 2e-5,
  bf16 (the tensor-core route) within B3's bf16 tolerance of
  tests/test_torch_attention_cuda.py (rtol 2e-2, atol 8e-3).
* ``Model.decode_multi`` captured and replayed equals its eager
  ``decode_step`` loop bitwise, DeepSeek-V2-Lite at full width cut to its
  dense layer and two MoE layers, bf16; the captured call makes no host
  sync; ``MLA_COUNTS`` shows one decompressed, padded call a layer in the
  prefill and one absorbed call a layer a step.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import mla as MLA
from repro_torch.models import model as M
from repro_torch.models import moe as TMoE

ARCH = "deepseek-v2-lite"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
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


def _rot(cfg, positions):
    return TL.yarn_cos_sin(positions, cfg.qk_rope_head_dim, cfg.rope_theta,
                           cfg.rope_scaling)


def _layer_run(layer, cfg, h, S: int, n: int):
    """A prefill of h[:, :S], then n decode steps of the next tokens from
    its cache grown by n slots: (prefill y, decode ys, cache)."""
    dev = h.device
    B = h.shape[0]
    with torch.no_grad():
        y, entry = layer.prefill(h[:, :S], _rot(cfg, torch.arange(S,
                                                                  device=dev)))
        cache = {k: torch.cat([t, t.new_zeros(B, n, t.shape[-1])], 1)
                 for k, t in entry.items()}
        ys = []
        for i in range(n):
            step = M.DecodeStep(S + i, B, dev)
            ys.append(layer.decode(h[:, S + i:S + i + 1],
                                   _rot(cfg, step.clen.reshape(1, 1)), cache,
                                   step))
    return y, torch.cat(ys, 1), cache


@pytest.mark.cuda
def test_mla_layer_on_the_card_equals_the_cpu(cuda_device, no_tf32):
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    dims = MLA.mla_dims(cfg)
    cpu = MLA.MLA(dims, torch.float32, "cpu",
                  torch.Generator().manual_seed(0))
    card = MLA.MLA(dims, torch.float32, cuda_device,
                   torch.Generator(cuda_device).manual_seed(1))
    card.load_state_dict(cpu.state_dict())
    B, S, n = 2, 256, 4
    h = torch.randn(B, S + n, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    want = _layer_run(cpu, cfg, h, S, n)
    got = _layer_run(card, cfg, h.to(cuda_device), S, n)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g.cpu(), w, atol=1e-4, rtol=1e-4)
    for k in want[2]:
        torch.testing.assert_close(got[2][k].cpu(), want[2][k], atol=1e-4,
                                   rtol=1e-4)


def _plain_attention(q_nope, q_pe, k_nope, k_pe, v, scale):
    """Causal attention over the unpadded heads, float32 from the same
    inputs."""
    q = torch.cat([q_nope, q_pe], -1).float().transpose(1, 2)
    H = q_nope.shape[2]
    k = torch.cat([k_nope, k_pe[:, :, None].expand(-1, -1, H, -1)],
                  -1).float().transpose(1, 2)
    s = q @ k.transpose(-1, -2) * scale
    S = s.shape[-1]
    mask = torch.ones(S, S, dtype=torch.bool, device=s.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    return (p @ v.float().transpose(1, 2)).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, dict(atol=2e-5, rtol=2e-5)),
    (torch.bfloat16, dict(atol=8e-3, rtol=2e-2))], ids=("f32", "bf16"))
def test_padded_b3_equals_the_plain_attention(cuda_device, no_tf32, dtype,
                                              tol):
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    dims = MLA.mla_dims(get_config(ARCH))
    B, S, H = 2, 640, dims.n_heads
    g = torch.Generator(cuda_device).manual_seed(3)

    def r(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    args = (r(B, S, H, dims.nope), r(B, S, H, dims.rope),
            r(B, S, H, dims.nope), r(B, S, dims.rope), r(B, S, H, dims.v))
    routes = dict(flash_attention_bhsd.launches_by_route)
    before = dict(MLA.MLA_COUNTS)
    got = MLA.decompressed_attention(*args, dims.scale)
    torch.cuda.synchronize()
    assert MLA.MLA_COUNTS["padded_b3"] == before["padded_b3"] + 1
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert flash_attention_bhsd.launches_by_route[route] == routes[route] + 1
    assert got.shape == (B, S, H, dims.v) and got.dtype == dtype
    torch.testing.assert_close(got.float(), _plain_attention(
        *args, dims.scale), **tol)


@pytest.mark.cuda
def test_captured_decode_multi_equals_stepwise(cuda_device):
    from test_torch_graph_cuda import (
        clone, model_case, no_sync, restore, stepwise, unequal_leaves,
    )
    before = dict(MLA.MLA_COUNTS)
    model, first, cache, S, ext = model_case(cuda_device, ARCH, n_layers=3)
    L = 3
    mid = dict(MLA.MLA_COUNTS)
    assert {k: mid[k] - before[k] for k in ("decompressed", "padded_b3",
                                            "absorbed")} == {
        "decompressed": L, "padded_b3": L, "absorbed": 0}
    steps = 8
    eager_cache, graph_cache = clone(cache), clone(cache)
    paths = dict(TMoE.PATH_CALLS)
    want = stepwise(model, first, eager_cache, S, steps, ext)
    assert MLA.MLA_COUNTS["absorbed"] - mid["absorbed"] == L * steps
    assert {k: v - paths[k] for k, v in TMoE.PATH_CALLS.items()} == {
        "fused": 2 * steps, "gather": 0, "routed": 0}
    for call in range(2):           # capture and replay, then replay only
        if call:
            restore(graph_cache, cache)
        got, _, _ = no_sync(lambda: model.decode_multi(first, graph_cache, S,
                                                       steps, ext))
        torch.cuda.synchronize()
        assert torch.equal(got, want), call
        assert unequal_leaves(graph_cache, eager_cache) == [], call
    assert model.graphs.captures == 1
