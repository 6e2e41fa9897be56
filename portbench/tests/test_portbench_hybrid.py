"""The ``gen_hybrid`` driver and its check, whole runs of the
``gen-hybrid-16k`` cell at a toy size on the CPU (the harness's look for
a card skipped): ``correct`` comes out true with the program sound, and
false when a decode step leaves the Mamba-2 state unchanged, when the
prefill's conv state is dropped from the cache, or when the shared
expert's output is left out.  And ``roofline_hybrid`` against a count by
hand."""
import copy
import tempfile

import pytest

from portbench import roofline_hybrid as RH
from portbench import run as R

TOY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
           num_hidden_layers=6, layer_types=["mamba", "attention",
                                             "mamba"] * 2,
           num_local_experts=8, num_experts_per_tok=2, intermediate_size=32,
           shared_intermediate_size=48, vocab_size=300, mamba_n_heads=8,
           mamba_d_head=16, mamba_d_state=8, mamba_n_groups=2,
           mamba_chunk_size=8)


def _gen(seed=2 ** 33 + 5, readings=False, trace=False):
    bench, work, conf, spec = R.cell(R.ROOT, "gen-hybrid-16k")
    conf = dict(copy.deepcopy(conf), **TOY)
    # the toy's own limit: its sound runs read mean gaps of 2e-5 to 2.5e-4
    # and each fault below 1e-2 or more (bf16 on the CPU, seed 2**33 + 5)
    spec = dict(spec, rows=4, prompt_tokens=20, new_tokens=6,
                warmup_batches=1, check_batches=2,
                limits={"mean_gap": 2e-3})
    job = R.Job(work, conf, spec, seed, 0.5, trace, tempfile.mkdtemp(),
                device="cpu", pin=False)
    return R.measure(bench, job, readings=readings)


def test_a_sound_run_is_correct_and_reads_its_spans():
    res = _gen(trace=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["ssm_prefill_ms.gen"]["value"] > 0
    assert m["ffn_prefill_ms.gen"]["value"] > 0
    assert 0 < m["mfu_hybrid.gen"]["value"] < 100


def test_the_control_is_judged_by_the_check():
    res = _gen(readings=True)
    assert res["control"]["correct"] == (
        res["correct"] and res["control"]["mean_gap"]
        <= res["checks"]["mean_gap"]["limit"])


def _state_unchanged(monkeypatch):
    from repro_torch.models import ssm
    step = ssm.mamba2_step
    monkeypatch.setattr(ssm, "mamba2_step", lambda p, x, dims, eps, state:
                        step(p, x, dims, eps,
                             {k: v.clone() for k, v in state.items()}))


def _conv_dropped(monkeypatch):
    from repro_torch.models import ssm
    block = ssm.mamba2_block

    def drop(*a, **k):
        y, st = block(*a, **k)
        return y, dict(st, conv=st["conv"] * 0)
    monkeypatch.setattr(ssm, "mamba2_block", drop)


def _no_shared_expert(monkeypatch):
    from repro_torch.models.model import HybridMoELayer

    def ffn(self, x):
        y, aux = self.moe(self.norm2(x))
        return x + y * self.res, aux
    monkeypatch.setattr(HybridMoELayer, "_ffn", ffn)


# also run at the cell's own size on the card by tools/hybrid_faults.py
FAULTS = (_state_unchanged, _conv_dropped, _no_shared_expert)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = _gen()
    assert not res["correct"]
    assert res["checks"]["mean_gap"]["value"] > \
        res["checks"]["mean_gap"]["limit"]


def test_roofline_against_a_hand_count():
    """One Mamba-2 and one attention layer, d 8, 2 heads of 4 (1 kv head),
    Mamba-2 2 heads of 8, d_state 2, 1 group, conv 4, chunks of 3;
    4 experts of 3, top-2, shared 5; vocabulary 10; B 1, S 4, 2 steps."""
    c = {"d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
         "layer_types": ["mamba", "attention"], "vocab_size": 10,
         "n_experts": 4, "top_k": 2, "d_ff_expert": 3, "shared_d_ff": 5,
         "ssm_heads": 2, "ssm_head_dim": 8, "d_state": 2, "n_groups": 1,
         "d_conv": 4, "chunk": 3}
    mamba = 4 * 2 * (8 * 38 + 16 * 8 + 4 * 20)   # 4 tokens: in, out, conv
    ssd = (6 + 1) * 2 * (2 + 16) + 4 * 4 * 2 * 8 * 2   # pairs; states
    attn = 4 * 2 * (8 * 4 * 4 + 8 * 8) + 10 * 4 * 2 * 4
    ffn = 2 * 4 * 2 * (8 * 4 + 3 * 8 * (2 * 3 + 5))
    assert RH.prefill_flops(c, 1, 4) == mamba + ssd + attn + ffn + 160
    step = 1024 + 4 * 2 * 8 * 2 + 384 + 2 * 592 + 160
    assert RH.decode_flops(c, 1, [5, 6]) == 2 * step + (5 + 6) * 32
    spec = {"rows": 1, "prompt_tokens": 4, "new_tokens": 2}
    assert RH.batch_flops(c, spec) == 11612 + 6112
