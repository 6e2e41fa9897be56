"""Whole runs of each kind of cell at a toy size on the CPU, the harness's
look for a card skipped, with the timed path sound and then broken
underneath: ``correct`` has to come out true, then false for each fault
the cell can have (a token altered where it is produced; half of the
batch left out; a step that leaves its state unchanged).  The exchange
between chips is no fault these one-chip cells can have."""
import copy
import tempfile

import pytest

from portbench import run as R

TOY = {"n_heads": 4, "n_kv_heads": 2, "head_dim": 16, "vocab": 256}


def _serve(fault=None, seed=2**33 + 7, readings=False):
    bench, work, conf, spec = R.cell(R.ROOT, "serve-decode-heavy")
    conf, spec = copy.deepcopy(conf), copy.deepcopy(spec)
    conf["serving"].update(arch=None, kv_capacity_tokens=1 << 14,
                           widths=TOY)
    spec.update(rate_rps=8.0, warmup_s=0.5, check_tokens=10 ** 6,
                wait_s=30)
    spec["prompt_tokens"].update(median=40, max=200)
    spec["output_tokens"].update(median=12, min=4, max=40)
    job = R.Job(work, conf, spec, seed, 2.0, False, tempfile.mkdtemp(),
                device="cpu", pin=False, fault=fault)
    return R.measure(bench, job, readings=readings)


def _gen(fault=None, seed=5, readings=False):
    bench, work, conf, spec = R.cell(R.ROOT, "gen-decode")
    conf = copy.deepcopy(conf)
    conf["model"].update(hidden_size=64, num_attention_heads=4,
                         num_key_value_heads=2, num_hidden_layers=2,
                         num_local_experts=8, num_experts_per_tok=2,
                         intermediate_size=32, vocab_size=300)
    spec = dict(spec, rows=8, prompt_tokens=16, new_tokens=8,
                warmup_batches=1, check_batches=2)
    job = R.Job(work, conf, spec, seed, 0.5, False, tempfile.mkdtemp(),
                device="cpu", pin=False, fault=fault)
    return R.measure(bench, job, readings=readings)


def test_sound_runs_are_correct():
    res = _serve()
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["widest_gap"]["value"] == 0.0
    res = _gen()
    assert res["correct"]


def test_controls_are_judged_by_the_check():
    """With ``readings`` each driver judges the control by the check that
    judges the program, and the result carries the control's verdict."""
    for res in (_serve(readings=True), _gen(readings=True)):
        control = res["control"]
        assert isinstance(control["correct"], bool)
        name = next(k for k in res["checks"]
                    if k in ("widest_gap", "mean_gap"))
        assert control["correct"] == (
            res["correct"] and control[name] <= res["checks"][name]["limit"])


def _alter_one(plan, res):
    """The first decode row's token of each plan, altered."""
    if plan.decode:
        rid = plan.decode[0]
        if res.token_steps:
            row = res.token_steps[0]
            if rid in row:
                row[rid] = (row[rid] + 1) % TOY["vocab"]
        elif rid in res.tokens:
            res.tokens[rid] = (res.tokens[rid] + 1) % TOY["vocab"]
    return res


def _drop_half(plan, res):
    """Every other decode row's tokens left out."""
    for rid in plan.decode[::2]:
        res.tokens.pop(rid, None)
        for row in res.token_steps or []:
            row.pop(rid, None)
    return res


def test_serve_token_altered():
    res = _serve(_alter_one)
    assert not res["correct"]
    assert res["checks"]["widest_gap"]["value"] > \
        res["checks"]["widest_gap"]["limit"]


def test_serve_half_the_batch_left_out():
    res = _serve(_drop_half)
    assert not res["correct"]
    assert res["checks"]["count_mismatch"]["value"] > 0


def test_serve_state_unchanged(monkeypatch):
    from repro_torch.backend.surrogate import PagedSurrogateBackend
    monkeypatch.setattr(PagedSurrogateBackend, "_write",
                        lambda self, chunks: None)
    res = _serve()
    assert not res["correct"]


def _wrap_decode(change):
    def fault(model):
        inner = model.decode_multi

        def decode_multi(*a, **k):
            out, cache, clen = inner(*a, **k)
            return change(out), cache, clen
        model.decode_multi = decode_multi
    return fault


def test_gen_token_altered():
    def alter(out):
        out = out.clone()
        out[:, 3] = (out[:, 3] + 1) % 300
        return out
    res = _gen(_wrap_decode(alter))
    assert not res["correct"]


def test_gen_half_the_batch_left_out():
    def drop(out):
        out = out.clone()
        out[::2] = 0
        return out
    res = _gen(_wrap_decode(drop))
    assert not res["correct"]


def test_gen_state_unchanged(monkeypatch):
    import repro_torch.models.model as M
    monkeypatch.setattr(M, "write_slot", lambda cache, new, idx: None)
    res = _gen()
    assert not res["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["serve-decode-heavy", "gen-decode",
                                  "serve-long-prompt", "gen-prefill"])
def test_control_fails_on_the_card(card, cell):
    """At the cell's own size, on three seeds: the program is correct and
    the control (the reference a precision lower), judged by the same
    check, is not."""
    import json
    import subprocess
    import sys
    for seed in (1001, 1002, 1003):
        out = subprocess.run(
            [sys.executable, str(R.ROOT / "portbench" / "run.py"),
             "--workload", cell, "--seed", str(seed), "--seconds", "10",
             "--trace", "0", "--readings", "1"],
            capture_output=True, text=True, timeout=900)
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert res["correct"]
        name = next(iter(k for k in res["checks"]
                         if k in ("widest_gap", "mean_gap")))
        assert res["control"][name] > res["checks"][name]["limit"]
        assert res["control"]["correct"] is False
