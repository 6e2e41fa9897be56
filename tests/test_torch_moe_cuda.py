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
* The combine (gather and sum, no atomics) at granite's prefill shape (8 x
  512 tokens: capacity 1,028) gives bitwise-equal outputs on two calls and
  equals the plain path's; ``moe_apply`` there, which takes the routed
  kernels, gives bitwise-equal outputs on two calls too.
* ``moe_apply`` makes no host sync on the card
  (``torch.cuda.set_sync_debug_mode("error")``), so that a decode loop
  stays on the device.

``routing_report`` also serves tests/test_torch_graph_cuda.py's whole
models on the card against the CPU.

The two kernel paths against the plain path on the same card, weights and
inputs (the plain side: ``_moe_gather``, and ``_route`` and ``_bucket``
for the buckets): the fused path (``kernels.moe_dispatch``, one dispatch
and one combine kernel, decode sizes) and the routed path
(``kernels.moe_routed``, route, offsets, fill and combine kernels,
everything past the fused path's limits that the card takes):

* fused: granite's widths over 64 and 8 tokens and qwen2-moe-a2.7b's (60
  experts top-4, d_model 2,048) over 64; routed: granite-4.0-h's widths
  (72 experts top-10, d_model 4,096) over 4, 64 and 4,096 tokens and over
  32,768 (its buckets 3.4 GB in bf16, past 2^31 bytes), granite's over
  4,096 and 32,640 (gen-prefill's prefill); DeepSeek-V2-Lite's (64 experts
  top-6, d_model 2,048, the gates not renormalised) fused over 4 (its
  decode step) and 64, routed over 4,096 and 32,768; each in float32 with
  TF32 off
  and in bf16, ``PATH_CALLS`` rising on the case's path alone: the
  kernels' expert sets (the dispatch run with room for every assignment,
  a thousand tokens at a time) equal the plain ones under the near-tie
  rule; on a seed without a near-tie the buckets are equal (the same
  tokens in the same slots, the same rows bitwise), the gates within rtol
  1e-6 (the softmax sums in another order: a few float32 steps), the aux
  loss within 1e-5, and the outputs within atol = rtol = 1e-5 in float32
  (the gates' last bits and the order of the k additions) and, in bf16,
  within 2^-6 of the largest output plus rtol 2^-7: a gate that differs
  in its last float32 bit can round to the neighbouring bf16 value, which
  moves one scaled row by a bf16 step (2^-8 of it), and the final
  rounding can then land one more step away;
* a router made to overflow four experts (every token's top four), on
  each path: the kernels drop exactly the assignments ``_bucket`` drops;
* on each path, two calls are bitwise equal, and a call makes no host
  sync;
* ``Model.decode_multi`` captured and replayed equals its eager
  ``decode_step`` loop bitwise: granite's widths cut to two layers on the
  fused path, granite-4.0-h's cut to two on the routed one.
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


def experts(arch: str, device, dtype, seed: int = 0) -> TMoE.MoE:
    cfg = get_config(arch)
    return TMoE.MoE(TMoE.moe_dims(cfg.moe, cfg.d_model), dtype, device,
                    torch.Generator(device).manual_seed(seed))


def granite_experts(device, dtype, seed: int = 0) -> TMoE.MoE:
    return experts("granite-moe-3b-a800m", device, dtype, seed)


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
        plain, _ = TMoE._moe_gather(params_of(layer), x, dims)
        before = dict(TMoE.PATH_CALLS)
        (ya, auxa), (yb, auxb) = (layer(x.reshape(8, 512, -1))
                                  for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(ya, yb) and torch.equal(auxa, auxb)
    assert torch.equal(plain, a)
    assert rises(before) == {"routed": 2}


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


# ---------------------------------------------------------------------------
# the fused dispatch and combine
# ---------------------------------------------------------------------------

HYBRID = "granite-4.0-h-small"
MLA_ARCH = "deepseek-v2-lite"       # 64 experts top-6, gates not renormalised
# (arch, tokens, path)
FUSED_CASES = [("granite-moe-3b-a800m", 64, "fused"),
               ("granite-moe-3b-a800m", 8, "fused"),
               ("qwen2-moe-a2.7b", 64, "fused"),
               (HYBRID, 4, "routed"), (HYBRID, 64, "routed"),
               (HYBRID, 4096, "routed"),
               (HYBRID, 32768, "routed"),       # xe 3.4 GB in bf16
               ("granite-moe-3b-a800m", 4096, "routed"),
               ("granite-moe-3b-a800m", 32640, "routed"),
               (MLA_ARCH, 4, "fused"), (MLA_ARCH, 64, "fused"),
               (MLA_ARCH, 4096, "routed"), (MLA_ARCH, 32768, "routed")]
# bf16 outputs: two bf16 steps (module docstring)
BF16_TOL = 2.0 ** -7


def dispatch_of(path: str):
    """The dispatch wrapper of the kernels' ``path``."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch
    from repro_torch.kernels.moe_routed import moe_routed_dispatch
    return {"fused": moe_dispatch, "routed": moe_routed_dispatch}[path]


def rises(before: dict) -> dict:
    """The ``PATH_CALLS`` entries that rose since ``before``, by how
    much."""
    return {k: v - before[k] for k, v in TMoE.PATH_CALLS.items()
            if v != before[k]}


def fused_buckets(slots, N: int, C: int, E: int):
    """The token in each bucket slot [E, C] (N where empty) from a kernel
    dispatch's slot lists."""
    tok = torch.full((E * C,), N, dtype=torch.long, device=slots.device)
    s = slots.long()
    keep = s >= 0
    tok[s[keep]] = torch.arange(N, device=slots.device)[:, None].expand_as(
        s)[keep]
    return tok.reshape(E, C)


SET_CHUNK = 1024     # tokens a dispatch of ``fused_sets_report`` takes


def fused_sets_report(layer, x, path: str) -> dict:
    """The ``path`` kernels' expert sets (the dispatch run with a capacity
    of every token, so nothing drops, over at most ``SET_CHUNK`` tokens at
    a time: a token's routing is its own) against the plain path's on the
    same card, under the near-tie rule."""
    dispatch = dispatch_of(path)
    dims, N = layer.dims, x.shape[0]
    k = dims.top_k
    got = []
    for lo in range(0, N, SET_CHUNK):
        part = x[lo:lo + SET_CHUNK]
        n = part.shape[0]
        _, _, slots, _ = dispatch(part.float() @ layer.router, part,
                                  dims.n_experts, k, n)
        assert (slots >= 0).all()
        got.append((slots.long() // n).sort(-1).values)
    got = torch.cat(got)
    probs = TMoE.router_probs(layer.router, x, dims)
    top = torch.topk(probs, k + 1, dim=-1)
    want = top.indices[:, :k].sort(-1).values
    gap = top.values[:, k - 1] - top.values[:, k]
    differ = (got != want).any(-1)
    return {"differ": int(differ.sum()),
            "near_ties": int((differ & (gap <= NEAR_TIE)).sum())}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("arch,n_tokens,path", FUSED_CASES,
                         ids=[f"{a[:5]}-{n}" if p == "fused" else
                              f"{p}-{a.split('-')[0]}{a.split('-')[1][0]}-{n}"
                              for a, n, p in FUSED_CASES])
def test_fused_path_matches_the_plain_path(cuda_device, no_tf32, arch,
                                           n_tokens, path, dtype):
    """A kernel path against the plain path (``_moe_gather``; ``_route``
    and ``_bucket`` for the buckets) on the same card, weights and inputs,
    at ``arch``'s widths over ``n_tokens`` tokens, on the first of
    ``SEEDS`` without a near-tie, at the limits of the module docstring."""
    dispatch = dispatch_of(path)
    reports = []
    for seed in SEEDS:
        layer = experts(arch, cuda_device, dtype, seed)
        dims, params = layer.dims, params_of(layer)
        x = torch.randn((n_tokens, dims.d_model), device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(
                            seed + 10)).to(dtype)
        C = TMoE._capacity(n_tokens, dims)
        with torch.no_grad():
            rep = fused_sets_report(layer, x, path)
            reports.append((seed, rep))
            assert rep["differ"] == rep["near_ties"], reports
            if rep["near_ties"]:
                continue
            before = dict(TMoE.PATH_CALLS)
            y, aux = TMoE._moe_local(params, x, dims)
            assert rises(before) == {path: 1}
            y_p, aux_p = TMoE._moe_gather(params, x, dims)
            gates, idx, _ = TMoE._route(layer.router, x, dims)
            xe_p, ge_p, tok_p = TMoE._bucket(x, gates, idx, C, dims)
            del gates, idx
            xe, ge, slots, _ = dispatch(x.float() @ layer.router, x,
                                        dims.n_experts, dims.top_k, C,
                                        renormalize=dims.renormalize)
        assert torch.equal(fused_buckets(slots, n_tokens, C, dims.e_pad),
                           tok_p)
        assert torch.equal(xe, xe_p)
        del xe, xe_p
        torch.testing.assert_close(ge, ge_p, atol=0, rtol=1e-6)
        torch.testing.assert_close(aux, aux_p, atol=1e-5, rtol=1e-5)
        if dtype == torch.float32:
            torch.testing.assert_close(y, y_p, atol=1e-5, rtol=1e-5)
        else:
            torch.testing.assert_close(
                y.float(), y_p.float(), rtol=BF16_TOL,
                atol=2 * BF16_TOL * y_p.float().abs().max().item())
        return
    pytest.fail(f"every seed had a near-tie: {reports}")


# (dtype, arch, tokens, path): a router made to overflow four experts
DROP_CASES = [(torch.float32, "granite-moe-3b-a800m", 64, "fused"),
              (torch.bfloat16, "granite-moe-3b-a800m", 64, "fused"),
              (torch.float32, HYBRID, 256, "routed"),
              (torch.bfloat16, HYBRID, 256, "routed")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,arch,N,path", DROP_CASES,
                         ids=("f32", "bf16", "routed-f32", "routed-bf16"))
def test_fused_path_drops_what_bucket_drops(cuda_device, no_tf32, dtype,
                                            arch, N, path):
    dispatch = dispatch_of(path)
    reports = []
    for seed in SEEDS:
        layer = experts(arch, cuda_device, dtype, seed)
        dims = layer.dims
        g = torch.Generator(cuda_device).manual_seed(seed + 20)
        x = torch.randn((N, dims.d_model), device=cuda_device,
                        generator=g).abs().to(dtype)
        with torch.no_grad():
            # every token's top four: 0..3, by a margin of ~60 in the
            # logits (0.05 at granite's 1,536), which leaves the other
            # probabilities above float32's underflow, where exact ties at
            # 0 would make every token a near-tie
            layer.router[:, :4] += 76.8 / dims.d_model
            rep = fused_sets_report(layer, x, path)
            reports.append((seed, rep))
            assert rep["differ"] == rep["near_ties"], reports
            if rep["near_ties"]:
                continue
            C = TMoE._capacity(N, dims)
            gates, idx, _ = TMoE._route(layer.router, x, dims)
            assert (idx.sort(-1).values[:, :4]
                    == torch.arange(4, device=cuda_device)).all()
            xe_p, _, tok_p = TMoE._bucket(x, gates, idx, C, dims)
            before = dict(TMoE.PATH_CALLS)
            TMoE._moe_local(params_of(layer), x, dims)
            assert rises(before) == {path: 1}
            xe, _, slots, _ = dispatch(x.float() @ layer.router, x,
                                       dims.n_experts, dims.top_k, C)
        dropped = int((slots < 0).sum())
        assert dropped >= 4 * (N - C)
        assert dropped == N * dims.top_k - int((tok_p < N).sum())
        assert torch.equal(fused_buckets(slots, N, C, dims.e_pad), tok_p)
        assert torch.equal(xe, xe_p)
        return
    pytest.fail(f"every seed had a near-tie: {reports}")


# (arch, tokens, path): a decode step of each kernel path, and a prefill
REPEAT_CASES = {"fused": ("granite-moe-3b-a800m", 64, "fused"),
                "routed-decode": (HYBRID, 4, "routed"),
                "routed-prefill": (HYBRID, 4096, "routed")}


@pytest.mark.cuda
@pytest.mark.parametrize("case", REPEAT_CASES)
def test_fused_path_repeats_bitwise_and_makes_no_host_sync(cuda_device,
                                                          case):
    arch, n, path = REPEAT_CASES[case]
    layer = experts(arch, cuda_device, torch.bfloat16)
    x = torch.randn((n, 1, layer.dims.d_model), device=cuda_device,
                    dtype=torch.bfloat16)
    with torch.no_grad():
        ya, auxa = layer(x)                          # warm-up, allocations
        torch.cuda.synchronize()
        before = dict(TMoE.PATH_CALLS)
        torch.cuda.set_sync_debug_mode("error")
        try:
            yb, auxb = layer(x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert rises(before) == {path: 1}
    assert torch.equal(ya, yb) and torch.equal(auxa, auxb)


# (arch, path, the cut): two layers of granite-moe and of granite-4.0-h
# (its first two, both Mamba-2)
CAPTURE_CASES = {
    "fused": ("granite-moe-3b-a800m", "fused", dict(n_layers=2)),
    "routed": (HYBRID, "routed", dict(
        n_layers=2, layer_types=get_config(HYBRID).layer_types[:2])),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CAPTURE_CASES)
def test_captured_decode_multi_takes_the_fused_path_bitwise(cuda_device,
                                                           case):
    from test_torch_graph_cuda import (
        clone, model_case, no_sync, restore, stepwise, unequal_leaves,
    )
    arch, path, cut = CAPTURE_CASES[case]
    model, first, cache, S, ext = model_case(cuda_device, arch, **cut)
    steps = 8
    eager_cache, graph_cache = clone(cache), clone(cache)
    before = dict(TMoE.PATH_CALLS)
    want = stepwise(model, first, eager_cache, S, steps, ext)
    assert rises(before) == {path: 2 * steps}
    for call in range(2):           # capture and replay, then replay only
        if call:
            restore(graph_cache, cache)
        before = dict(TMoE.PATH_CALLS)
        got, _, _ = no_sync(lambda: model.decode_multi(first, graph_cache, S,
                                                       steps, ext))
        torch.cuda.synchronize()
        assert set(rises(before)) == ({path} if call == 0 else set())
        assert torch.equal(got, want), call
        assert unequal_leaves(graph_cache, eager_cache) == [], call
    assert model.graphs.captures == 1
