"""The plain references against the port at a tiny size on the CPU, and
the frozen copies against the program's originals."""
import copy
import dataclasses

import numpy as np
import torch

from portbench import run as R, traffic
from portbench.drivers import gen, recorder
from portbench.reference import granite_moe as ref
from portbench.reference.bpe import serving_tokenizer
from portbench.reference.surrogate import Surrogate, draw_params

TOY = {"n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "vocab": 256}


def test_frozen_copies_equal_the_programs():
    from repro_torch.backend import surrogate as port
    from repro_torch.tokenizer.bpe import default_tokenizer
    a = draw_params(**{k: TOY[k] for k in ("n_heads", "n_kv_heads",
                                           "head_dim", "vocab")}, seed=3)
    b = port.draw_params(**{k: TOY[k] for k in ("n_heads", "n_kv_heads",
                                                "head_dim", "vocab")},
                         seed=3)
    for k in a:
        assert np.array_equal(a[k], b[k])
    ours, theirs = serving_tokenizer(), default_tokenizer()
    for r in traffic.open_loop({"rate_rps": 20.0, "prompt_tokens": {
            "dist": "fixed", "value": 300}, "output_tokens": {
            "dist": "fixed", "value": 4}}, 9, 1.0):
        text = r.text + " HTTP 2048 ms, GB!"
        assert ours.encode(text) == theirs.encode(text)


def _plan(step, prefill=(), decode=(), tables=None, toks=None, k=1,
          budgets=None):
    from repro_torch.serving.scheduler import StepPlan
    return StepPlan(step, list(prefill), list(decode), [],
                    block_tables=tables or {}, new_tokens=toks or {},
                    num_steps=k, decode_steps=budgets or {})


def test_surrogate_reference_against_the_leaf():
    """TorchBackend on the CPU through prefill chunks, single steps and a
    k-step plan: every token it samples is the reference's best."""
    from repro_torch.backend.torch_backend import TorchBackend
    leaf = TorchBackend(block_size=4, num_blocks=64, max_steps=4,
                        device="cpu", **TOY)
    rng = np.random.default_rng(0)
    prompts = {1: rng.integers(0, 256, 9).tolist(),
               2: rng.integers(0, 256, 6).tolist()}
    tables = {1: list(range(0, 8)), 2: list(range(8, 16))}
    log = []

    def run(plan):
        log.append((plan, leaf.execute(plan)))
        return log[-1][1]

    run(_plan(0, [(1, 0, 5), (2, 0, 6)], [], tables,
              {1: prompts[1][:5], 2: prompts[2]}))
    r = run(_plan(1, [(1, 5, 4)], [2], tables,
                  {1: prompts[1][5:], 2: [7]}))
    r = run(_plan(2, [], [1, 2], tables, {1: [r.tokens[1]], 2: [3]}))
    run(_plan(3, [], [1, 2], tables, {1: [r.tokens[1]], 2: [r.tokens[2]]},
              k=4, budgets={1: 4, 2: 2}))
    model = Surrogate(TOY, 0, "cpu")
    n = 0
    for rid, events in recorder.streams(log).items():
        from portbench.drivers.serve import _segments
        (stream, emits), = _segments(events)
        assert stream[:len(prompts[rid])] == prompts[rid]
        logits = model.logits(stream, [L for L, _ in emits])
        served = torch.tensor([t for _, t in emits])
        gap = logits.max(-1).values - logits.gather(1, served[:, None])[:, 0]
        assert gap.max().item() < 1e-5
        n += len(emits)
    assert n == 2 + 2 + 2 + 4 + 2


def _tiny(capacity=0.5):
    _, _, conf, _ = R.cell(R.ROOT, "gen-decode")
    conf = copy.deepcopy(conf)
    conf["model"].update(hidden_size=64, num_attention_heads=4,
                         num_key_value_heads=2, num_hidden_layers=2,
                         num_local_experts=4, num_experts_per_tok=2,
                         intermediate_size=32, vocab_size=300,
                         capacity_factor=capacity)
    return conf


def test_granite_reference_against_the_model():
    """The port's Model in float32 with the benchmark's weights: prefill
    logits equal the reference's, and each greedy token decode_multi
    serves is the reference's best, with the experts dropping tokens at
    capacity in both."""
    from repro_torch.models.model import Model, grow_cache
    conf = _tiny()
    mc = gen.model_config(conf)
    cfg = dataclasses.replace(gen.port_config(conf), dtype="float32")
    model = Model(cfg, device="meta").to_empty(device="cpu")
    params = dict(model.named_parameters())
    w = ref.make_weights(mc, 11, "cpu")
    with torch.no_grad():
        for ours, theirs in gen.param_map(cfg).items():
            params[theirs].copy_(w[ours].reshape(params[theirs].shape))
    B, S, n = 3, 12, 5
    tokens = torch.randint(0, 300, (B, S), generator=torch.Generator()
                           .manual_seed(2), dtype=torch.int32)
    logits, cache = model.prefill(tokens)
    want = ref.logits_at(w, mc, tokens, [(0, S)], [S - 1])
    assert torch.allclose(logits[:, :, :300].float(), want, atol=1e-4)
    first = logits[:, 0, :300].argmax(-1).to(torch.int32)[:, None]
    out, _, _ = model.decode_multi(first, grow_cache(cache, cfg, B, S + n),
                                   S, n)
    fed = torch.cat([tokens, first, out[:, :-1]], 1)
    groups = [(0, S)] + [(S + i, S + i + 1) for i in range(n)]
    lg = ref.logits_at(w, mc, fed, groups, list(range(S - 1, S + n)))
    served = torch.cat([first, out], 1).long()
    gap = lg.max(-1).values - lg.gather(2, served[..., None])[..., 0]
    assert gap.max().item() < 1e-4
    # the capacity drops some assignments at this factor
    probs = torch.softmax(torch.randn(B, S, 4), -1)
    idx = torch.topk(probs, 2, -1).indices
    assert ref.capacity(B * S, 2, 0.5, 4) < B * S * 2 / 4
    assert not ref._kept(idx, [(0, S)], B, mc).all()


def test_controls_round_as_stated():
    from portbench.reference.numerics import matmul, round_fp8, round_tf32
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, 3.0])
    assert round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0]
    y = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    err = (round_fp8(y, 0) - y).abs().max() / y.abs().max()
    assert 0 < err < 2 ** -4
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    assert torch.allclose(matmul(a, b, "float32"), a @ b)
    assert not torch.equal(matmul(a, b, "fp8"), a @ b)
