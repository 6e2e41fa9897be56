"""DeepSeek-V2 on the port (``MLAConfig``, ``models.mla``, the latent
attention ``AttnLayer``) against its plain reference
(``tests/plain/deepseek_v2.py``), on the CPU at toy widths in float32.

The toy model keeps the published ratios: one dense layer then two MoE
layers; 4 heads whose query and key are 16 plain and 8 rotary values and
whose value is 16, over a latent of 32; YaRN at the published factor,
original length and betas (its ramp falls inside the 4 rotary
frequencies); 8 experts top-2, gates not renormalised, and 2 ungated
shared experts.  Its weights are the program's own draw from a seeded
generator, carried to the reference's names with the rotary columns put
back in the published interleaved order.  Tolerances: logits within atol
1e-4 and rtol 1e-4 (float32 on both sides; the products and the softmax
sum in other orders, and the program pads B3's heads and takes the
absorbed path in decode); an MLA layer's absorbed decode against its own
decompressed prefill within 1e-5 (one layer, the same sums
reassociated); captured-loop twins bit for bit (the same statements).
"""
from __future__ import annotations

import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import profiling
from repro_torch.configs import ARCHS, PORT_ARCHS, get_config
from repro_torch.models import layers as TL
from repro_torch.models import mla as MLA
from repro_torch.models import model as M
from repro_torch.models import moe as TMoE

from plain import deepseek_v2 as plain

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "deepseek-v2-lite"


def tiny(**over):
    cfg = get_config(ARCH)
    cfg = dataclasses.replace(
        cfg, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=24,
        d_ff=96, vocab_size=257, vocab_pad_multiple=8, dtype="float32",
        kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, moe=dataclasses.replace(cfg.moe, n_experts=8,
                                               top_k=2, d_ff_expert=24))
    return dataclasses.replace(cfg, **over)


def sizes(cfg):
    """The reference's view of ``cfg`` (the benchmark's keys)."""
    ys = cfg.rope_scaling
    return {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
            "n_layers": cfg.n_layers,
            "first_k_dense_replace": cfg.first_k_dense_replace,
            "vocab_size": cfg.vocab_size, "padded_vocab": cfg.padded_vocab,
            "kv_lora_rank": cfg.kv_lora_rank,
            "qk_nope_head_dim": cfg.qk_nope_head_dim,
            "qk_rope_head_dim": cfg.qk_rope_head_dim,
            "v_head_dim": cfg.v_head_dim, "rope_theta": cfg.rope_theta,
            "rope_scaling": {
                "factor": ys.factor,
                "original_max_position_embeddings": ys.original_max_position,
                "beta_fast": ys.beta_fast, "beta_slow": ys.beta_slow,
                "mscale": ys.mscale, "mscale_all_dim": ys.mscale_all_dim},
            "d_ff": cfg.d_ff, "n_experts": cfg.moe.n_experts,
            "top_k": cfg.moe.top_k, "d_ff_expert": cfg.moe.d_ff_expert,
            "shared_d_ff": cfg.moe.n_shared_experts * cfg.moe.d_ff_expert,
            "renormalize": cfg.moe.renormalize,
            "capacity_factor": cfg.moe.capacity_factor,
            "norm_eps": cfg.norm_eps}


def rope_to_interleaved(w, rope: int):
    """The inverse of ``mla.rope_from_interleaved``: the program's rotary
    columns back in the published order."""
    out = w.clone()
    out[..., -rope:] = w[..., -rope:][..., torch.argsort(
        MLA._rope_order(rope))]
    return out


def layer_of(model, i):
    k = model.cfg.first_k_dense_replace
    return (model.stages["mla_dense"][i]["layer0"] if i < k
            else model.stages["mla_moe"][i - k]["layer0"])


def weights(model):
    """The model's parameters under the reference's names, in the
    published layouts."""
    cfg = model.cfg
    Dr = cfg.qk_rope_head_dim
    w = {"embed": model.embed, "final_norm": model.final_norm.scale,
         "lm_head": model.lm_head}
    for i in range(cfg.n_layers):
        layer, p = layer_of(model, i), f"l{i}."
        a = layer.attn
        w[p + "norm1"], w[p + "norm2"] = layer.norm1.scale, layer.norm2.scale
        w[p + "wq"] = rope_to_interleaved(a.wq.detach(), Dr).flatten(1)
        w[p + "wkv_a"] = rope_to_interleaved(a.wkv_a.detach(), Dr)
        w[p + "kv_norm"] = a.kv_norm.scale
        w[p + "wkv_b"] = a.wkv_b.flatten(1)
        w[p + "wo"] = a.wo.flatten(0, 1)
        if i < cfg.first_k_dense_replace:
            for n in ("gate", "up", "down"):
                w[p + "mlp_" + n] = getattr(layer.mlp, "w_" + n)
        else:
            for n in ("router", "w_gate", "w_up", "w_down"):
                w[p + n] = getattr(layer.moe, n)
            for n in ("gate", "up", "down"):
                w[p + "shared_" + n] = getattr(layer.shared_mlp, "w_" + n)
    return {k: t.detach() for k, t in w.items()}


@pytest.fixture(scope="module")
def toy():
    cfg = tiny()
    model = M.Model(cfg, generator=torch.Generator().manual_seed(13),
                    device="cpu")
    return cfg, model, weights(model)


def tokens(B, L, vocab, seed=3):
    return torch.randint(0, vocab, (B, L),
                         generator=torch.Generator().manual_seed(seed))


# -- the configuration -----------------------------------------------------


def test_the_published_model_is_built_whole():
    """27 layers (one dense, 26 MoE), 15.71 B parameters, every width as
    published; a port-only architecture beside ``ARCHS``' ten."""
    cfg = get_config(ARCH)
    assert ARCH in PORT_ARCHS and ARCH not in ARCHS and len(ARCHS) == 10
    plan = M.build_plan(cfg)
    assert [(s.name, s.n_periods) for s in plan] == [("mla_dense", 1),
                                                     ("mla_moe", 26)]
    assert [s.specs[0].kind for s in plan] == ["mla", "mla"]
    assert (plan[0].specs[0].mlp, plan[1].specs[0].moe) == ("swiglu", True)
    model = M.Model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 15_706_484_224
    a = layer_of(model, 5).attn
    assert tuple(a.wq.shape) == (2048, 16, 192)
    assert tuple(a.wkv_a.shape) == (2048, 576)
    assert tuple(a.wkv_b.shape) == (512, 16, 256)
    assert tuple(a.wo.shape) == (16, 128, 2048)
    moe = layer_of(model, 5)
    assert tuple(moe.moe.w_gate.shape) == (64, 2048, 1408)
    assert tuple(moe.shared_mlp.w_gate.shape) == (2048, 2816)
    assert not hasattr(moe, "shared_gate")
    assert tuple(layer_of(model, 0).mlp.w_gate.shape) == (2048, 10944)
    assert tuple(model.lm_head.shape) == (102_400, 2048)
    assert moe.moe.dims.renormalize is False


def test_shared_experts_gate_is_a_config_field():
    """qwen2-moe's shared experts sit behind a gate, DeepSeek-V2-Lite's and
    granite-4.0-h's do not; no third layer class."""
    assert get_config("qwen2-moe-a2.7b").moe.shared_gated
    assert not get_config(ARCH).moe.shared_gated
    assert not get_config("granite-4.0-h-small").moe.shared_gated
    axes = M.param_axes(get_config(ARCH))["mla_moe"]["layer0"]
    assert "shared_mlp" in axes and "shared_gate" not in axes
    assert axes["attn"] == M._stack_axes(MLA.mla_param_axes())
    gated = M.param_axes(get_config("qwen2-moe-a2.7b"))["moe"]["layer0"]
    assert "shared_gate" in gated
    layer = M.AttnLayer(M.LayerSpec(kind="attn", moe=True), dataclasses.replace(
        get_config("qwen2-moe-a2.7b"), d_model=16, n_heads=2, n_kv_heads=2,
        d_head=8, dtype="float32", moe=dataclasses.replace(
            get_config("qwen2-moe-a2.7b").moe, n_experts=4, top_k=2,
            d_ff_expert=8, n_shared_experts=1, shared_gated=False)),
        M.head_layout(2, 2, 8), "cpu", torch.Generator().manual_seed(0))
    assert hasattr(layer, "shared_mlp") and not hasattr(layer, "shared_gate")
    h, y = torch.randn(3, 16), torch.randn(3, 16)
    torch.testing.assert_close(M.shared_experts(layer, h, y),
                               y + layer.shared_mlp(h))


@pytest.mark.parametrize("name", sorted(PORT_ARCHS))
def test_tiny_config_keeps_the_gates_and_shared_experts(name):
    """``launch.train.tiny_config`` (quickstart's and train's toy) builds a
    fresh ``MoEConfig``; the port-only fields come from the family."""
    from repro_torch.launch.train import tiny_config
    moe = get_config(name).moe
    tiny = tiny_config(get_config(name)).moe
    assert (tiny.renormalize, tiny.shared_gated) == (moe.renormalize,
                                                     moe.shared_gated)
    assert tiny.n_experts == 8 and tiny.top_k == 2


def test_cache_specs_hold_the_latent_cache():
    """``{ckv [periods, B, Sc, 512], kpe [periods, B, Sc, 64]}`` a stage,
    1,152 bytes a token and layer in bf16; ``grow_cache`` pads the slots
    and ``cache_axes`` replicates them over the heads' axis."""
    cfg = get_config(ARCH)
    specs = M.cache_specs(cfg, 4, 32_896)
    assert {st: {n: tuple(t.shape) for n, t in e["layer0"].items()}
            for st, e in specs.items()} == {
        "mla_dense": {"ckv": (1, 4, 32_896, 512), "kpe": (1, 4, 32_896, 64)},
        "mla_moe": {"ckv": (26, 4, 32_896, 512), "kpe": (26, 4, 32_896, 64)}}
    total = sum(t.numel() * t.element_size() for e in specs.values()
                for t in e["layer0"].values())
    assert total == 27 * 4 * 32_896 * 1152
    assert M.cache_axes(cfg)["mla_moe"]["layer0"] == {
        "ckv": (None, "dp", None, None), "kpe": (None, "dp", None, None)}
    small = tiny()
    pre = {st: {"layer0": {n: torch.randn(t.shape[0], 2, 5, t.shape[-1])
                           for n, t in e["layer0"].items()}}
           for st, e in M.cache_specs(small, 2, 5).items()}
    grown = M.grow_cache(pre, small, 2, 9)
    for st in pre:
        for n, t in pre[st]["layer0"].items():
            g = grown[st]["layer0"][n]
            assert g.shape[2] == 9 and torch.equal(g[:, :, :5], t)
            assert not g[:, :, 5:].any()


# -- YaRN ------------------------------------------------------------------


def test_yarn_frequencies_and_mscale_follow_the_formulas():
    """The port's YaRN frequencies against the published code's (the
    plain reference's), and at DeepSeek-V2-Lite's widths against the
    correction range worked by hand: dimensions up to 10 keep theta's
    frequencies, from 23 on they are divided by 40; mscale(40, 0.707) =
    0.1 x 0.707 x ln 40 + 1; the softmax scale mscale^2 / sqrt(192), and
    cos and sin unscaled since mscale equals mscale_all_dim."""
    cfg = get_config(ARCH)
    ys = cfg.rope_scaling
    got = TL.yarn_frequencies(64, cfg.rope_theta, ys)
    want = plain.yarn_inv_freq(sizes(cfg))
    torch.testing.assert_close(got, want, atol=0, rtol=1e-6)
    base = TL.rope_frequencies(64, cfg.rope_theta)
    corr = [64 * math.log(4096 / (r * 2 * math.pi)) / (2 * math.log(1e4))
            for r in (32, 1)]
    assert (math.floor(corr[0]), math.ceil(corr[1])) == (10, 23)
    torch.testing.assert_close(got[:11], base[:11], atol=0, rtol=1e-6)
    torch.testing.assert_close(got[23:], base[23:] / 40, atol=0, rtol=1e-6)
    assert bool((got[11:23] < base[11:23]).all())
    m = 0.1 * 0.707 * math.log(40) + 1
    assert TL.yarn_mscale(40, 0.707) == pytest.approx(m, rel=1e-12)
    assert TL.yarn_mscale(1, 0.707) == 1.0
    assert MLA.mla_dims(cfg).scale == pytest.approx(m * m / math.sqrt(192),
                                                    rel=1e-12)
    assert MLA.mla_dims(cfg).scale == pytest.approx(
        plain.softmax_scale(sizes(cfg)), rel=1e-12)
    pos = torch.arange(7)
    cos, sin = TL.yarn_cos_sin(pos, 64, cfg.rope_theta, ys)
    ang = pos[:, None].float() * got
    torch.testing.assert_close(cos[:, 0], torch.cos(ang), atol=0, rtol=0)
    torch.testing.assert_close(sin[:, 0], torch.sin(ang), atol=0, rtol=0)


def test_rope_columns_reorder_and_rotate_as_published():
    """Published-layout columns reordered once, then the port's halves
    rotary, give the published interleaved rotary's result; the reorder
    and its inverse undo each other."""
    cfg = tiny()
    Dr = cfg.qk_rope_head_dim
    w = torch.randn(8, 3, 4 + Dr, generator=torch.Generator().manual_seed(1))
    assert torch.equal(rope_to_interleaved(
        MLA.rope_from_interleaved(w, Dr), Dr), w)
    h = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(2))
    pos = torch.arange(5)
    want = plain.rope((h @ w.flatten(1)).view(2, 5, 3, -1)[..., 4:]
                      .transpose(1, 2), pos, sizes(cfg)).transpose(1, 2)
    ours = MLA.rope_from_interleaved(w, Dr)
    got = TL.rotate((h @ ours.flatten(1)).view(2, 5, 3, -1)[..., 4:],
                    *TL.yarn_cos_sin(pos, Dr, cfg.rope_theta,
                                     cfg.rope_scaling))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# -- the model against the plain reference ---------------------------------


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_prefill_logits_match_the_plain_reference(toy, factor):
    """Every position's logits of a prefill (``Model.forward``) and the
    last one's from ``Model.prefill``; at capacity factor 0.5 the experts
    drop assignments past capacity."""
    cfg, model, w = toy
    if factor != cfg.moe.capacity_factor:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=factor))
        small = M.Model(cfg, device="meta").to_empty(device="cpu")
        small.load_state_dict(model.state_dict())
        model = small
    B, S = 2, 13
    tok = tokens(B, S, cfg.vocab_size)
    want = plain.logits_at(w, sizes(cfg), tok, [(0, S)], range(S))
    got = model(tok)[..., :cfg.vocab_size]
    torch.testing.assert_close(got, want, **TOL)
    last, _ = model.prefill(tok)
    torch.testing.assert_close(last[:, 0, :cfg.vocab_size], want[:, -1],
                               **TOL)


def test_prefill_then_decode_matches_the_full_forward(toy):
    """Prefill, then each next token through the latent cache (the
    absorbed path), against the reference over the whole stream, routed
    call by call."""
    cfg, model, w = toy
    B, S, n = 3, 11, 6
    tok = tokens(B, S + n, cfg.vocab_size, seed=5)
    _, cache = model.prefill(tok[:, :S])
    cache = M.grow_cache(cache, cfg, B, S + n)
    got = []
    for i in range(n):
        logits, cache = model.decode_step(tok[:, S + i:S + i + 1], cache,
                                          S + i)
        got.append(logits[:, 0, :cfg.vocab_size])
    groups = [(0, S)] + [(S + i, S + i + 1) for i in range(n)]
    want = plain.logits_at(w, sizes(cfg), tok, groups, range(S, S + n))
    torch.testing.assert_close(torch.stack(got, 1), want, **TOL)


def test_decode_multi_equals_stepwise_decoding(toy):
    """The captured loop's eager twin on the CPU: the same greedy tokens
    and the same final latent cache, bit for bit, as a ``decode_step``
    loop."""
    cfg, model, _ = toy
    B, S, n = 2, 9, 5
    tok = tokens(B, S, cfg.vocab_size, seed=7)
    logits, pre = model.prefill(tok)
    first = logits[:, 0, :cfg.vocab_size].argmax(-1)[:, None].int()
    a = M.grow_cache(pre, cfg, B, S + n)
    b = M.grow_cache(pre, cfg, B, S + n)
    out, a, clen = model.decode_multi(first, a, S, n)
    cur, steps = first, []
    for i in range(n):
        lg, b = model.decode_step(cur, b, S + i)
        cur = lg[:, 0, :cfg.vocab_size].argmax(-1)[:, None].int()
        steps.append(cur)
    assert torch.equal(out, torch.cat(steps, 1)) and int(clen) == S + n
    for stage in a:
        for name in a[stage]["layer0"]:
            assert torch.equal(a[stage]["layer0"][name],
                               b[stage]["layer0"][name])


def test_absorbed_decode_equals_the_decompressed_prefill():
    """One MLA layer in float32: each token's absorbed decode over the
    latent cache equals that position of a decompressed prefill over the
    whole stream, and the cache it wrote equals the prefill's entry."""
    cfg = tiny()
    dims = MLA.mla_dims(cfg)
    layer = MLA.MLA(dims, torch.float32, "cpu",
                    torch.Generator().manual_seed(4))
    B, S, n = 2, 7, 4
    h = torch.randn(B, S + n, cfg.d_model,
                    generator=torch.Generator().manual_seed(5))

    def rot(pos):
        return TL.yarn_cos_sin(pos, dims.rope, cfg.rope_theta,
                               cfg.rope_scaling)
    with torch.no_grad():
        y_full, whole = layer.prefill(h, rot(torch.arange(S + n)))
        _, entry = layer.prefill(h[:, :S], rot(torch.arange(S)))
        cache = {k: torch.cat([t, t.new_zeros(B, n, t.shape[-1])], 1)
                 for k, t in entry.items()}
        for i in range(n):
            step = M.DecodeStep(S + i, B, "cpu")
            y = layer.decode(h[:, S + i:S + i + 1],
                             rot(step.clen.reshape(1, 1)), cache, step)
            torch.testing.assert_close(y[:, 0], y_full[:, S + i], atol=1e-5,
                                       rtol=1e-5)
    for k in cache:
        torch.testing.assert_close(cache[k], whole[k], atol=1e-5, rtol=1e-5)


def test_gates_are_not_renormalised_on_the_plain_path():
    """``_route`` with ``renormalize`` off keeps the top-k probabilities
    as they are (their sums under one); on, they sum to one; the moe layer
    weights each expert by the unrenormalised gate (capacity for every
    token here: nothing is dropped)."""
    cfg = tiny()
    dims = TMoE.moe_dims(dataclasses.replace(cfg.moe, capacity_factor=8.0),
                         cfg.d_model)
    assert dims.renormalize is False
    layer = TMoE.MoE(dims, torch.float32, "cpu",
                     torch.Generator().manual_seed(6))
    x = torch.randn(10, cfg.d_model, generator=torch.Generator().manual_seed(7))
    probs = TMoE.router_probs(layer.router, x, dims)
    gates, idx, _ = TMoE._route(layer.router, x, dims)
    torch.testing.assert_close(gates, torch.topk(probs, 2, dim=-1).values,
                               atol=0, rtol=0)
    assert bool((gates.sum(-1) < 1 - 1e-3).all())
    on = dataclasses.replace(dims, renormalize=True)
    g_on, idx_on, _ = TMoE._route(layer.router, x, on)
    torch.testing.assert_close(g_on.sum(-1), torch.ones(10))
    assert torch.equal(idx, idx_on)
    with torch.no_grad():
        y, _ = layer(x[None])
    want = torch.zeros_like(x)
    for t in range(10):
        for j in range(2):
            e = int(idx[t, j])
            want[t] += gates[t, j] * plain.swiglu(
                x[t], layer.w_gate[e], layer.w_up[e], layer.w_down[e])
    torch.testing.assert_close(y[0], want, atol=1e-5, rtol=1e-5)


# -- counters and spans ----------------------------------------------------


def test_counters_count_each_path(toy):
    """A prefill: one decompressed call and one padded B3 call a layer,
    B x S latent slots a layer; a decode step: one absorbed call and B
    slots a layer."""
    cfg, model, _ = toy
    B, S, L = 2, 6, cfg.n_layers
    before = dict(MLA.MLA_COUNTS)
    _, cache = model.prefill(tokens(B, S, cfg.vocab_size))
    mid = dict(MLA.MLA_COUNTS)
    assert {k: mid[k] - before[k] for k in before} == {
        "decompressed": L, "absorbed": 0, "latent_slots": L * B * S,
        "padded_b3": L}
    cache = M.grow_cache(cache, cfg, B, S + 1)
    model.decode_step(tokens(B, 1, cfg.vocab_size), cache, S)
    assert {k: MLA.MLA_COUNTS[k] - mid[k] for k in mid} == {
        "decompressed": 0, "absorbed": L, "latent_slots": L * B,
        "padded_b3": 0}


def test_model_spans_time_the_latent_attention_and_the_ffn(toy):
    cfg, model, _ = toy
    spans = profiling.start_model_spans()
    try:
        model.prefill(tokens(1, 6, cfg.vocab_size))
    finally:
        assert profiling.stop_model_spans() is spans
    assert spans.counts == {"mla_mixer": 3, "ffn": 3}
    assert set(spans.totals()) == {"mla_mixer", "ffn"} <= set(
        profiling.MODEL_SITES)


# -- the benchmark's copy of the reference ---------------------------------


def test_the_two_reference_copies_agree():
    """``portbench/reference/deepseek_v2.py`` (attention over blocks of
    queries, weights drawn by its ``make_weights``) against this plain
    copy on toy weights, the experts dropping past capacity; float32 both;
    and the fp8 control reads otherwise."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.reference import deepseek_v2 as bench
    mc = sizes(tiny(moe=dataclasses.replace(tiny().moe,
                                            capacity_factor=0.5)))
    w = bench.make_weights(mc, 2 ** 40 + 11, torch.device("cpu"))
    assert {n for n, _, _ in bench.shapes(mc)} == set(w)
    tok = tokens(2, 14, mc["vocab_size"], seed=9)
    groups = [(0, 10)] + [(10 + i, 11 + i) for i in range(4)]
    want = plain.logits_at(w, mc, tok, groups, range(9, 14))
    got = bench.logits_at(w, mc, tok, groups, range(9, 14))
    torch.testing.assert_close(got, want, **TOL)
    h = torch.randn(1, 11, mc["d_model"],
                    generator=torch.Generator().manual_seed(10))
    wl = {k[3:]: t.float() for k, t in w.items() if k.startswith("l1.")}
    torch.testing.assert_close(bench._mla(h, wl, mc, "float32", block=4),
                               bench._mla(h, wl, mc, "float32"), **TOL)
    assert not torch.equal(bench.logits_at(w, mc, tok, groups, range(9, 14),
                                           "fp8"), got)
