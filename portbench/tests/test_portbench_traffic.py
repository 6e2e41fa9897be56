"""The generator: every seed gets the same work, the seed fixes the
schedule and the texts, and each text has exactly its token count."""
import json

import numpy as np
import pytest

from portbench import run as R, traffic
from portbench.reference.bpe import serving_tokenizer

SEEDS = (0, 7, 2**31 + 12345, 2**33 + 1)


def _spec(name):
    return json.loads((R.ROOT / "portbench" / "traffic"
                       / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["serve-decode-heavy", "serve-long-prompt"])
def test_seed_fixes_schedule_and_texts(name):
    spec = _spec(name)
    a = traffic.open_loop(spec, SEEDS[2], 5.0)
    b = traffic.open_loop(spec, SEEDS[2], 5.0)
    c = traffic.open_loop(spec, SEEDS[3], 5.0)
    assert [(r.t_due, r.text, r.max_new) for r in a] == \
        [(r.t_due, r.text, r.max_new) for r in b]
    assert [r.text for r in a] != [r.text for r in c]


@pytest.mark.parametrize("name", ["serve-decode-heavy", "serve-long-prompt"])
def test_every_seed_gets_the_same_work(name):
    spec = _spec(name)
    runs = [traffic.open_loop(spec, s, 5.0) for s in SEEDS]
    for reqs in runs[1:]:
        assert sorted(r.n_prompt for r in reqs) == \
            sorted(r.n_prompt for r in runs[0])
        assert sorted(r.max_new for r in reqs) == \
            sorted(r.max_new for r in runs[0])
        gaps = np.diff([0.0] + [r.t_due for r in reqs])
        ref = np.diff([0.0] + [r.t_due for r in runs[0]])
        assert np.allclose(np.sort(gaps), np.sort(ref))
    n = len(runs[0])
    assert n == round(spec["rate_rps"] * 5.0)
    assert runs[0][-1].t_due == pytest.approx(5.0, rel=0.05)


def test_texts_have_exact_token_counts():
    spec = _spec("serve-long-prompt")
    tok = serving_tokenizer()
    for r in traffic.open_loop(spec, 3, 1.0)[:20] + traffic.warmup(spec, 3):
        assert len(tok.encode(r.text)) == r.n_prompt
        lo, hi = spec["prompt_tokens"]["min"], spec["prompt_tokens"]["max"]
        assert lo <= r.n_prompt <= hi


def test_shared_prefix_groups():
    spec = dict(_spec("serve-decode-heavy"),
                shared_prefix={"groups": 2, "tokens": 64})
    tok = serving_tokenizer()
    reqs = traffic.open_loop(spec, 5, 1.0)
    heads = {tuple(tok.encode(r.text)[:64]) for r in reqs}
    assert len(heads) == 2
    for r in reqs[:10]:
        assert len(tok.encode(r.text)) == r.n_prompt


def test_lengths_and_gaps_follow_their_distributions():
    ln = traffic.lengths({"dist": "lognormal", "median": 128, "sigma": 0.6,
                          "min": 16, "max": 1024}, 1001)
    assert ln[500] == 128 and ln.min() >= 16 and ln.max() <= 1024
    g = traffic.gaps({"arrival": "poisson"}, 40.0, 4000)
    assert g.mean() == pytest.approx(1 / 40.0, rel=0.01)
    g = traffic.gaps({"arrival": "gamma", "cv": 2.0}, 40.0, 4000)
    assert g.std() / g.mean() == pytest.approx(2.0, rel=0.15)


def test_batch_tokens_fixed_by_seed():
    import torch
    spec = _spec("gen-decode")
    a = traffic.batch_tokens(spec, 2**33 + 3, 4, 49155, "cpu")
    b = traffic.batch_tokens(spec, 2**33 + 3, 4, 49155, "cpu")
    c = traffic.batch_tokens(spec, 2**33 + 3, 5, 49155, "cpu")
    assert a.shape == (64, 256) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.max()) < 49155
