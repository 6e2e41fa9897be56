"""Tails over every request, spans in a window, intervals, and the work a
kernel or a model needs at a known shape."""
import math
from types import SimpleNamespace

import pytest

from portbench import roofline, stats


def test_percentile_counts_every_request_and_misses():
    v = [float(i) for i in range(1, 101)]
    assert stats.percentile(v, 95) == 95.0
    assert stats.percentile(v, 50) == 50.0
    # five misses among a hundred: the 95th percentile is still answered
    v5 = v[:95] + [stats.MISSING] * 5
    assert stats.percentile(v5, 95) == 95.0
    # six: the 95th percentile is a miss
    v6 = v[:94] + [stats.MISSING] * 6
    assert math.isinf(stats.percentile(v6, 95))


def test_serving_medians_and_tails_count_every_request():
    """The serving cells' TTFT and TPOT medians and tails run over every
    request due in the window; one never answered sorts above the rest."""
    from portbench.drivers import serve
    sent = {rid: (rid, 10.0 + rid) for rid in range(4)}
    results = {rid: {"t_first_token": 10.0 + rid + 0.001 * (rid + 1),
                     "t_done": 10.0 + rid + 0.001 * (rid + 1) + 0.002 * 10,
                     "n_generated": 11} for rid in range(3)}
    e2e = serve.end_to_end({"sent": sent, "results": results,
                            "t_open": 10.0, "t_close": 14.0})
    assert e2e["ttft_p50_ms"] == pytest.approx(2.0)
    assert e2e["tpot_p50_ms"] == pytest.approx(2.0)
    assert math.isinf(e2e["ttft_p95_ms"]) and math.isinf(e2e["tpot_p95_ms"])
    assert e2e["serve_tok_s"] == pytest.approx(33 / 4.0)


def test_spread_is_quartiles_over_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_span_windowing_and_union():
    spans = [SimpleNamespace(t0=t, dur=0.5) for t in (0.5, 1.0, 1.9, 3.0)]
    assert [s.t0 for s in stats.in_window(spans, 1.0, 3.0)] == [1.0, 1.9]
    assert stats.merge([(0, 1), (0.5, 2), (3, 4)]) == [(0, 2), (3, 4)]
    assert stats.covered([(0, 1), (0.5, 2), (3, 4)], 1.5, 3.5) == \
        pytest.approx(1.0)


def test_tokens_in_window():
    # 11 tokens: the first at 1, ten more evenly over (1, 3]
    assert stats.tokens_in_window(1.0, 3.0, 11, 0.0, 10.0) == 11
    assert stats.tokens_in_window(1.0, 3.0, 11, 2.0, 10.0) == \
        pytest.approx(5.0)
    assert stats.tokens_in_window(1.0, 3.0, 11, 0.0, 2.0) == \
        pytest.approx(6.0)


def test_flash_and_decode_counts_at_a_known_shape():
    c = roofline.flash_call(8, 512, 14, 2, 64)
    assert c["flops"] == 4 * 64 * 14 * 8 * (512 * 513 // 2)
    assert c["bytes"] == 2 * (2 * 8 * 512 * 14 * 64 + 2 * 8 * 512 * 2 * 64)
    d = roofline.decode_call(64, 4096, 14, 2, 64, 4096)
    assert d["flops"] == 4 * 64 * 14 * 64 * 4096
    assert d["bytes"] == 2 * (2 * 64 * 14 * 64 + 2 * 64 * 4096 * 2 * 64) \
        + 4 * 64 + 4 * 4096
    # PERF.md's bound of B2 at this shape: 0.0401 ms, by bytes
    assert roofline.bound_s(d["flops"], d["bytes"],
                            roofline.PEAKS["bf16_flops"]) * 1e3 == \
        pytest.approx(0.0401, rel=0.01)


def test_model_flops_at_a_known_shape():
    cfg = {"d_model": 1536, "n_heads": 24, "n_kv_heads": 8, "head_dim": 64,
           "n_layers": 32, "vocab_size": 49155, "n_experts": 40, "top_k": 8,
           "d_ff_expert": 512}
    per_tok = 2 * (1536 * 1536 * 2 + 1536 * 512 * 2 + 8 * 3 * 1536 * 512
                   + 1536 * 40)
    assert roofline.layer_matmul_flops(cfg) == per_tok
    pre = roofline.prefill_flops(cfg, 2, 16)
    assert pre == 32 * (32 * per_tok + 4 * 64 * 24 * 2 * 136) \
        + 2 * 2 * 1536 * 49155
    dec = roofline.decode_flops(cfg, 2, [17, 18])
    assert dec == 2 * (32 * 2 * per_tok + 2 * 2 * 1536 * 49155) \
        + 32 * 4 * 64 * 24 * 2 * (17 + 18)
