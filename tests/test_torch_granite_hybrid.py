"""granite-4.0-h on the port (``HybridMoEConfig``, ``models.ssm.Mamba2``,
``models.model.HybridMoELayer``) against its plain reference
(``tests/plain/granite_4_h.py``), on the CPU at toy widths in float32.

The toy model has two periods of [mamba, attention, mamba], Mamba-2 with
two groups of B and C, 8 experts top-2 and a shared expert with no gate
(``MoEConfig.shared_gated`` off, as granite-4.0-h's configuration has it), and
granite's multipliers; its weights are the program's own draw from a
seeded generator, carried to the reference's names.  The experts drop
tokens past capacity in both.  Tolerances: logits within atol 1e-4 and
rtol 1e-4 (float32 on both sides; the program sums the SSD in chunks and
the products in other orders, the reference position by position); the
Mamba-2 block and its states within 1e-5 (one layer, the same sums
reordered); captured-loop twins and the zamba2 block bit for bit (the
same statements).
"""
from __future__ import annotations

import dataclasses
import hashlib
import sys
import types
from pathlib import Path

import pytest
import torch

from repro_torch import profiling
from repro_torch.configs import ARCHS, PORT_ARCHS, get_config
from repro_torch.configs.base import Mamba2Config, MoEConfig, SSMConfig
from repro_torch.kernels import ssd as SK
from repro_torch.models import model as M
from repro_torch.models import ssm as TS

from plain import granite_4_h as plain

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "granite-4.0-h-small"


def tiny(**over):
    cfg = dataclasses.replace(
        get_config(ARCH), n_layers=6,
        layer_types=("mamba", "attention", "mamba") * 2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=32, vocab_size=257,
        vocab_pad_multiple=8, dtype="float32", shared_d_ff=48,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      shared_gated=False),
        ssm=Mamba2Config(version=2, d_state=8, d_conv=4, expand=2,
                         head_dim=16, chunk=8, n_groups=2))
    return dataclasses.replace(cfg, **over)


def sizes(cfg):
    """The reference's view of ``cfg`` (the benchmark's keys)."""
    dims = TS.ssm_dims(cfg.ssm, cfg.d_model)
    return {"d_model": cfg.d_model, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
            "n_layers": cfg.n_layers, "layer_types": list(cfg.layer_types),
            "vocab_size": cfg.vocab_size, "padded_vocab": cfg.padded_vocab,
            "n_experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
            "d_ff_expert": cfg.moe.d_ff_expert, "shared_d_ff": cfg.shared_d_ff,
            "capacity_factor": cfg.moe.capacity_factor,
            "ssm_heads": dims.n_heads, "ssm_head_dim": dims.head_dim,
            "d_state": dims.d_state, "n_groups": dims.groups,
            "d_conv": dims.d_conv, "chunk": dims.chunk,
            "norm_eps": cfg.norm_eps,
            "embedding_multiplier": cfg.embedding_multiplier,
            "attention_multiplier": cfg.attention_multiplier,
            "residual_multiplier": cfg.residual_multiplier,
            "logits_scaling": cfg.logits_scaling}


def weights(model):
    """The model's parameters under the reference's names, [d_in, d_out]
    for attention's products."""
    cfg = model.cfg
    w = {"embed": model.embed, "final_norm": model.final_norm.scale}
    P = cfg.period()
    for i, kind in enumerate(cfg.layer_types):
        layer = model.stages["hybrid_moe"][i // P][f"layer{i % P}"]
        p = f"l{i}."
        w[p + "norm1"], w[p + "norm2"] = layer.norm1.scale, layer.norm2.scale
        if kind == "mamba":
            for n, t in layer.ssm.params().items():
                w[p + ("ssm_norm" if n == "norm" else n)] = t
        else:
            for n in ("wq", "wk", "wv"):
                w[p + n] = getattr(layer.attn, n).flatten(1)
            w[p + "wo"] = layer.attn.wo.flatten(0, 1)
        for n in ("router", "w_gate", "w_up", "w_down"):
            w[p + n] = getattr(layer.moe, n)
        for n in ("gate", "up", "down"):
            w[p + "shared_" + n] = getattr(layer.shared_mlp, "w_" + n)
    return {k: t.detach() for k, t in w.items()}


@pytest.fixture(scope="module")
def toy():
    cfg = tiny()
    model = M.Model(cfg, generator=torch.Generator().manual_seed(11),
                    device="cpu")
    return cfg, model, weights(model)


def tokens(B, L, vocab, seed=3):
    return torch.randint(0, vocab, (B, L),
                         generator=torch.Generator().manual_seed(seed))


# -- the configuration -----------------------------------------------------


def test_port_only_architecture_is_found_and_kept_out_of_archs():
    cfg = get_config(ARCH)
    assert ARCH in PORT_ARCHS and ARCH not in ARCHS and len(ARCHS) == 10
    assert cfg.layer_types.count("attention") == 4
    assert [i for i, t in enumerate(cfg.layer_types)
            if t == "attention"] == [5, 15, 25, 35]
    plan = M.build_plan(cfg)
    assert [(s.name, s.n_periods) for s in plan] == [("hybrid_moe", 4)]
    assert [s.kind for s in plan[0].specs] == ["ssm"] * 5 + ["attn"] + \
        ["ssm"] * 4
    assert not any(s.use_rope for s in plan[0].specs if s.kind == "attn")
    half = dataclasses.replace(cfg, n_layers=20,
                               layer_types=cfg.layer_types[:20])
    assert M.build_plan(half)[0].n_periods == 2
    dims = TS.ssm_dims(cfg.ssm, cfg.d_model)
    assert (dims.n_heads, dims.head_dim, dims.conv_dim) == (128, 64, 8448)
    with pytest.raises(KeyError):
        get_config("granite-4.0-h-nothing")


# -- the model against the plain reference ---------------------------------


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_prefill_logits_match_the_plain_reference(toy, factor):
    """Every position's logits of a prefill (``Model.forward``) and the
    last one's from ``Model.prefill``; at capacity factor 0.5 the experts
    drop assignments past capacity (at 1.25 this prompt fills none)."""
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


def test_loss_fn_ce_matches_the_plain_reference(toy):
    """The training loss's cross-entropy (``Model.loss_fn``, the chunked
    CE on the final norm's output) against the CE of the reference's
    logits, ``logits_scaling`` included; the same tolerance as the
    logits (the mean over positions of sums within it)."""
    cfg, model, w = toy
    B, S = 2, 12
    tok = tokens(B, S + 1, cfg.vocab_size, seed=4)
    _, parts = model.loss_fn({"tokens": tok[:, :S], "targets": tok[:, 1:]})
    want = plain.logits_at(w, sizes(cfg), tok[:, :S], [(0, S)], range(S))
    ce = torch.nn.functional.cross_entropy(
        want.reshape(B * S, -1), tok[:, 1:].reshape(-1).long())
    torch.testing.assert_close(parts["ce"], ce, **TOL)


def test_prefill_then_decode_matches_the_full_forward(toy):
    """Prefill, then each next token through the cache, against the
    reference over the whole stream, routed call by call."""
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
    want = plain.logits_at(w, sizes(cfg), tok, groups,
                           range(S, S + n))
    torch.testing.assert_close(torch.stack(got, 1), want, **TOL)


def test_decode_multi_equals_stepwise_decoding(toy):
    """The captured loop's eager twin on the CPU: the same greedy tokens
    and the same final cache, bit for bit, as a ``decode_step`` loop."""
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
        for key in a[stage]:
            for name in a[stage][key]:
                assert torch.equal(a[stage][key][name], b[stage][key][name])


# -- the Mamba-2 block -----------------------------------------------------


def block_of(chunk):
    dims = TS.ssm_dims(Mamba2Config(version=2, d_state=8, d_conv=4,
                                    expand=2, head_dim=8, chunk=chunk,
                                    n_groups=2), 32)
    blk = TS.Mamba2(dims, 1e-5, torch.float32, "cpu",
                    torch.Generator().manual_seed(chunk))
    w = {("ssm_norm" if k == "norm" else k): v.detach()
         for k, v in blk.params().items()}
    cfg = {"ssm_heads": dims.n_heads, "ssm_head_dim": dims.head_dim,
           "d_state": dims.d_state, "n_groups": dims.groups,
           "d_conv": dims.d_conv, "norm_eps": blk.eps}
    return blk, w, cfg


@pytest.mark.parametrize("chunk,S", [(256, 300), (64, 300), (64, 64),
                                     (256, 5)])
def test_mamba2_block_matches_the_recurrence(chunk, S):
    """The chunked SSD over a prompt that is (or is not) a whole number
    of chunks, against the reference's position-by-position recurrence;
    then a prefill split in two, and decode steps from its state."""
    blk, w, cfg = block_of(chunk)
    x = torch.randn((2, S + 3, 32), generator=torch.Generator().manual_seed(S))
    want = plain.mamba2(x, w, cfg)
    with torch.no_grad():
        y, st = blk(x[:, :S])
        torch.testing.assert_close(y, want[:, :S], atol=1e-5, rtol=1e-5)
        a = S // 3 or 1
        y1, s1 = blk(x[:, :a])
        y2, s2 = blk(x[:, a:S], s1)
        torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=1e-5,
                                   rtol=1e-5)
        torch.testing.assert_close(s2["ssm"], st["ssm"], atol=1e-5,
                                   rtol=1e-5)
        assert torch.equal(s2["conv"], st["conv"])
        for t in range(S, S + 3):
            yt, st = blk(x[:, t:t + 1], st, in_place=True)
            torch.testing.assert_close(yt[:, 0], want[:, t], atol=1e-5,
                                       rtol=1e-5)


def test_mamba2_counts_its_calls_and_chunks():
    blk, _, _ = block_of(64)
    before = dict(TS.MAMBA2_COUNTS)
    with torch.no_grad():
        _, st = blk(torch.randn(1, 130, 32))
        blk(torch.randn(1, 1, 32), st, in_place=True)
    assert TS.MAMBA2_COUNTS["calls"] - before["calls"] == 2
    assert TS.MAMBA2_COUNTS["chunks"] - before["chunks"] == 3
    assert TS.MAMBA2_COUNTS["kernel_calls"] == before["kernel_calls"]


@pytest.mark.parametrize("grad", ["off", "weights"])
def test_ssd_keeps_the_plain_path_on_the_cpu_and_under_grad(grad):
    """On the CPU, with or without a gradient to keep, every call runs
    ``ssd_reference``: ``calls`` counts, ``kernel_calls`` does not."""
    blk, _, _ = block_of(64)
    before = dict(TS.MAMBA2_COUNTS)
    x = torch.randn(1, 70, 32, generator=torch.Generator().manual_seed(5))
    with torch.set_grad_enabled(grad != "off"):
        y, _ = blk(x)
    rise = {k: TS.MAMBA2_COUNTS[k] - before[k] for k in before}
    assert rise == {"calls": 1, "chunks": 2, "kernel_calls": 0}
    assert y.requires_grad is (grad == "weights")


def _ssd_args(nh=8, G=1, n=128, hd=64, S=16, dtype=torch.float32):
    """dt, A, Bg, Cg for ``ssd`` beside an x of ``dtype``."""
    return (torch.zeros(1, S, nh), torch.zeros(nh),
            torch.zeros(1, S, G, n, dtype=dtype),
            torch.zeros(1, S, G, n, dtype=dtype))


SSD_ROWS = {
    # name: (card, grad, x requires grad, A requires grad, sizes, dtype,
    # what ``ssd`` does: the plain path, the kernel, or the error it raises)
    "cpu": (False, False, False, False, {}, torch.bfloat16, "plain"),
    "card": (True, False, False, False, {}, torch.bfloat16, "kernel"),
    "card_float32": (True, False, False, False, {}, torch.float32,
                     TypeError),
    "grad_on_nothing_requires_it": (True, True, False, False, {},
                                    torch.bfloat16, "kernel"),
    "grad_through_x": (True, True, True, False, {}, torch.bfloat16,
                       RuntimeError),
    "grad_through_A": (True, True, False, True, {}, torch.bfloat16,
                       RuntimeError),
    "head_dim_32": (True, False, False, False, {"hd": 32}, torch.bfloat16,
                    ValueError),
    "d_state_64": (True, False, False, False, {"n": 64}, torch.bfloat16,
                   ValueError),
    "two_heads_a_group": (True, False, False, False, {"nh": 8, "G": 4},
                          torch.bfloat16, ValueError),
    "float16": (True, False, False, False, {}, torch.float16, TypeError),
}


@pytest.mark.parametrize("name", sorted(SSD_ROWS))
def test_ssd_takes_the_kernel_only_where_the_call_shows_it(name,
                                                           monkeypatch):
    """``ssd`` at chunk 256 for an x that shows the row's device, grad and
    type: the plain path on the CPU; on the card the kernel, refused before
    any launch where a gradient is needed, and refused by the wrapper's
    check at sizes or a type it does not take.  The kernel runs only on the
    card, so a stand-in x shows the card and the launch is replaced by the
    wrapper's check on the CPU tensors.  And the chunks
    ``kernels.ssd.takes``."""
    card, grad, x_grad, a_grad, sizes, dtype, want = SSD_ROWS[name]
    sz = {"nh": 8, "G": 1, "n": 128, "hd": 64, **sizes}
    dt, A, Bg, Cg = _ssd_args(**sz, dtype=dtype)
    A.requires_grad_(a_grad)
    real = torch.zeros(1, 16, sz["nh"], sz["hd"], dtype=dtype)
    x = real if not card else types.SimpleNamespace(
        is_cuda=True, requires_grad=x_grad, real=real)

    def launch(x, *args):
        SK._check(x.real, *args)
        return "kernel"

    monkeypatch.setattr(SK, "ssd_chunk", launch)
    before = TS.MAMBA2_COUNTS["kernel_calls"]
    with torch.set_grad_enabled(grad):
        if isinstance(want, str):
            got = TS.ssd(x, dt, A, Bg, Cg, 256)
            assert (got if got == "kernel" else "plain") == want
        else:
            with pytest.raises(want):
                TS.ssd(x, dt, A, Bg, Cg, 256)
    assert TS.MAMBA2_COUNTS["kernel_calls"] - before == (want == "kernel")
    for chunk, takes in ((64, True), (192, True), (256, True), (32, False),
                         (96, False), (512, False)):
        assert SK.takes(64, 128, 8, 1, chunk, torch.bfloat16) is takes


def test_ssd_kernel_takes_the_published_block_and_refuses_cpu_tensors():
    cfg = get_config(ARCH)
    dims = TS.ssm_dims(cfg.ssm, cfg.d_model)
    assert SK.takes(dims.head_dim, dims.d_state, dims.n_heads, dims.groups,
                    dims.chunk, torch.bfloat16)
    dt, A, Bg, Cg = _ssd_args(nh=4)
    before = SK.ssd_chunk.launches
    with pytest.raises(ValueError):
        SK.ssd_chunk(torch.zeros(1, 16, 4, 64), dt, A, Bg, Cg, 64)
    assert SK.ssd_chunk.launches == before


def _zamba2_block_digest():
    """zamba2's Mamba-2 block at a toy width: a prefill from zero and one
    step from its state, all outputs and states hashed."""
    dims = TS.ssm_dims(SSMConfig(version=2, d_state=8, d_conv=4, expand=2,
                                 head_dim=16, chunk=16), 64)
    g = torch.Generator().manual_seed(7)
    blk = TS.Mamba(dims, torch.float32, "cpu", g)
    with torch.no_grad():
        for name in ("dt_bias", "D", "conv_b"):
            p = getattr(blk, name)
            p.add_(0.3 * torch.randn(p.shape, generator=g))
        y, st = blk(torch.randn((2, 24, 64), generator=g))
        st = {k: v.clone() for k, v in st.items()}
        y1, st1 = blk(torch.randn((2, 1, 64), generator=g), st)
    h = hashlib.sha256()
    for t in (y, st["conv"], st["ssm"], y1, st1["conv"], st1["ssm"]):
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def test_zamba2_mamba2_block_is_bit_identical_to_before():
    """The published block came beside zamba2's, not in its place: its
    outputs are those frozen before the change, bit for bit."""
    assert _zamba2_block_digest() == (
        "c072a0e20edebd6fe34661eb2544d1a16c43a40688eb6132a48d4eccd0e09fe9")


# -- the benchmark's copy of the reference ---------------------------------


def test_the_two_reference_copies_agree():
    """``portbench/reference/granite_4_h.py`` (chunked SSD, weights drawn
    by its ``make_weights``) against this plain copy on toy weights, the
    experts dropping past capacity; float32 both."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.reference import granite_4_h as bench
    mc = sizes(tiny(ssm=Mamba2Config(version=2, d_state=8, d_conv=4,
                                     expand=2, head_dim=16, chunk=4,
                                     n_groups=2)))
    w = bench.make_weights(mc, 2 ** 40 + 9, torch.device("cpu"))
    assert {n for n, _, _ in bench.shapes(mc)} == set(w)
    tok = tokens(2, 14, mc["vocab_size"], seed=9)
    groups = [(0, 10)] + [(10 + i, 11 + i) for i in range(4)]
    want = plain.logits_at(w, mc, tok, groups, range(9, 14))
    got = bench.logits_at(w, mc, tok, groups, range(9, 14))
    torch.testing.assert_close(got, want, **TOL)
    assert not torch.equal(bench.logits_at(w, mc, tok, groups, range(9, 14),
                                           "fp8"), got)


# -- spans -----------------------------------------------------------------


def test_model_spans_are_off_by_default_and_time_each_kind(toy):
    cfg, model, _ = toy
    cpu = torch.device("cpu")
    assert profiling.model_span("ffn", cpu) is profiling._UNTIMED
    spans = profiling.start_model_spans()
    try:
        model.prefill(tokens(1, 6, cfg.vocab_size))
    finally:
        assert profiling.stop_model_spans() is spans
    assert spans.counts == {"ssm_mixer": 4, "attn_mixer": 2, "ffn": 6}
    assert set(spans.totals()) == {"ssm_mixer", "attn_mixer", "ffn"} <= set(
        profiling.MODEL_SITES)
    assert profiling.model_span("ssm_mixer", cpu) is profiling._UNTIMED
