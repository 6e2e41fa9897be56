"""The ``gen_mla`` driver and its check, whole runs of the ``gen-mla-32k``
cell at a toy size on the CPU (the harness's look for a card skipped):
``correct`` comes out true with the program sound, and false when a
decode step leaves its latent slot unwritten, when ``k_pe`` is not
rotated, or when the experts' gates are renormalised.  The control is
judged by the same check.  And ``roofline_mla`` against a count by hand.
"""
import copy
import dataclasses
import tempfile

import pytest

from portbench import roofline_mla as RM
from portbench import run as R

TOY = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
           num_hidden_layers=3, first_k_dense_replace=1, kv_lora_rank=32,
           qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
           intermediate_size=96, moe_intermediate_size=24,
           n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=2,
           vocab_size=300)


def _gen(seed=2 ** 33 + 7, readings=False, trace=False):
    bench, work, conf, spec = R.cell(R.ROOT, "gen-mla-32k")
    conf = dict(copy.deepcopy(conf), **TOY)
    # the toy's own limit: its sound runs read mean gaps of 0 to 1.4e-4
    # over seeds 2**33 + 7..9, the faults below 0.019 to 0.29 (bf16 on the
    # CPU, seed 2**33 + 7)
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
    assert m["mla_prefill_ms.gen"]["value"] > 0
    assert m["ffn_prefill_ms.gen"]["value"] > 0
    assert 0 < m["mfu_mla.gen"]["value"] < 100
    # the other cells' readers find nothing of theirs here
    assert "mfu_hybrid.gen" not in m and "ssm_prefill_ms.gen" not in m


def test_the_control_is_judged_by_the_check():
    res = _gen(readings=True)
    assert res["control"]["correct"] == (
        res["correct"] and res["control"]["mean_gap"]
        <= res["checks"]["mean_gap"]["limit"])


def _slot_unwritten(monkeypatch):
    from repro_torch.models import mla
    monkeypatch.setattr(mla, "write_slot", lambda cache, new, idx: None)


def _kpe_not_rotated(monkeypatch):
    from repro_torch.models import mla
    project = mla.MLA._project

    def plain_kpe(self, h, rot):
        q_nope, q_pe, ckv, _ = project(self, h, rot)
        return q_nope, q_pe, ckv, (h @ self.wkv_a)[..., self.dims.kv_rank:]
    monkeypatch.setattr(mla.MLA, "_project", plain_kpe)


def _gates_renormalised(monkeypatch):
    from repro_torch.models import moe
    dims = moe.moe_dims
    monkeypatch.setattr(moe, "moe_dims", lambda *a, **k: dataclasses.replace(
        dims(*a, **k), renormalize=True))


FAULTS = (_slot_unwritten, _kpe_not_rotated, _gates_renormalised)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = _gen()
    assert not res["correct"]
    assert res["checks"]["mean_gap"]["value"] > \
        res["checks"]["mean_gap"]["limit"]


def test_roofline_against_a_hand_count():
    """A dense and an MoE layer, d 8, 2 heads of q/k 2 + 2 and v 3 over a
    latent of 4; dense width 5; 4 experts of 3, top-2, shared 6;
    vocabulary 10; B 1, S 4, 2 steps."""
    c = {"d_model": 8, "n_heads": 2, "kv_lora_rank": 4,
         "qk_nope_head_dim": 2, "qk_rope_head_dim": 2, "v_head_dim": 3,
         "n_layers": 2, "first_k_dense_replace": 1, "d_ff": 5,
         "n_experts": 4, "top_k": 2, "d_ff_expert": 3, "shared_d_ff": 6,
         "vocab_size": 10}
    proj = 2 * (8 * 2 * 4 + 8 * 6 + 4 * 2 * 5 + 2 * 3 * 8)     # W_q..W_o
    ffn = 2 * 3 * 8 * 5 + 2 * (8 * 4 + 3 * 8 * (2 * 3 + 6))   # dense, moe
    pairs = 2 * 10 * 2 * 2 * (4 + 3)                # 2 layers, 10 pairs
    assert RM.prefill_flops(c, 1, 4) == 4 * (2 * proj + ffn) + pairs + 160
    step = 2 * proj + ffn + 160
    slots = 2 * (5 + 6) * 2 * 2 * (4 + 2 + 4)       # 2 layers, 11 slots
    assert RM.decode_flops(c, 1, [5, 6]) == 2 * step + slots
    spec = {"rows": 1, "prompt_tokens": 4, "new_tokens": 2}
    assert RM.batch_flops(c, spec) == 7440 + 4560
