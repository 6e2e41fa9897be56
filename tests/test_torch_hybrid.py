"""The port's split-phase backend against ``repro``'s.

Twins of tests/test_hybrid.py's backend tests on
``repro_torch.backend.hybrid.HybridBackend``: ``split_plan`` routing (the
sub-plans' bytes equal the reference's), residency and handoff counters,
``make_backend``'s pairs and checks, and the int8 quantization at the
prefill->decode seam.  Then lockstep: ``repro``'s
``HybridBackend(JaxBackend -> CpuDecodeBackend)`` under ``repro``'s
scheduler and the port's ``HybridBackend(TorchBackend on the CPU ->
CpuDecodeBackend)`` under the port's must broadcast the same plan bytes
and sample the same tokens at every step.  The serve CLI runs a hybrid
once as a subprocess.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.backend.cpu_decode import CpuDecodeBackend as RefCpuDecode
from repro.backend.emulated import EmulatedBackend as RefEmulated
from repro.backend.hybrid import HybridBackend as RefHybrid
from repro.backend.jax_backend import JaxBackend
from repro.core.devmodel import DeviceModel as RefDeviceModel
from repro.serving.scheduler import StepPlan as RefStepPlan
from repro_torch.backend import ARCH_WIDTHS, make_backend
from repro_torch.backend.cpu_decode import CpuDecodeBackend
from repro_torch.backend.emulated import EmulatedBackend
from repro_torch.backend.hybrid import HybridBackend
from repro_torch.backend.torch_backend import TorchBackend
from repro_torch.core.devmodel import DeviceModel
from repro_torch.serving.scheduler import SchedulerConfig, StepPlan
from test_torch_backend import CASES, VOCAB, _params, drive_lockstep
from test_torch_engine import _serve


def _emu_pair(pkg: str = "port", **kw):
    Dev, Emu, Hyb = ((DeviceModel, EmulatedBackend, HybridBackend)
                     if pkg == "port" else
                     (RefDeviceModel, RefEmulated, RefHybrid))
    dev = Dev(t_fixed=0.0, t_prefill_tok=1e-6, t_decode_seq=1e-6,
              t_block_entry=0.0, t_swap_block=0.0)
    return Hyb(Emu(dev, sleep=False), Emu(dev, sleep=False), **kw)


def _plans(**fields):
    return StepPlan(**fields), RefStepPlan(**fields)


# -- plan splitting ----------------------------------------------------------

def test_split_plan_routes_phases_and_payloads():
    plan, ref_plan = _plans(
        step_id=5, prefill=[(1, 0, 16), (2, 16, 8)], decode=[3, 4],
        preempted=[9], block_tables={1: [0], 2: [1], 3: [2], 4: [3]},
        new_tokens={1: [7] * 16, 2: [8] * 8, 3: [1], 4: [2]})
    pre, dec = _emu_pair().split_plan(plan)
    assert pre.prefill == plan.prefill and pre.decode == []
    assert dec.decode == [3, 4] and dec.prefill == []
    assert set(pre.block_tables) == {1, 2} and set(dec.block_tables) == {3, 4}
    assert set(pre.new_tokens) == {1, 2} and set(dec.new_tokens) == {3, 4}
    # state drops fan out to BOTH children — either may hold state
    assert pre.preempted == [9] and dec.preempted == [9]
    ref_pre, ref_dec = _emu_pair("ref").split_plan(ref_plan)
    assert pre.encode() == ref_pre.encode()
    assert dec.encode() == ref_dec.encode()


def test_split_plan_routes_swaps_by_residency():
    be, ref = _emu_pair(), _emu_pair("ref")
    for b in (be, ref):
        b._remember(3, "decode")
    plan, ref_plan = _plans(
        step_id=1, prefill=[], decode=[1], preempted=[],
        swap_outs={2: [(0, 0)], 3: [(1, 1)], 4: [(2, 2)]},
        restores={1: [(2, 2)]}, decode_tier_swaps=[4])
    pre, dec = be.split_plan(plan)
    assert set(pre.swap_outs) == {2}
    assert set(dec.swap_outs) == {3, 4}
    assert set(dec.restores) == {1}
    for got, want in zip((pre, dec), ref.split_plan(ref_plan)):
        assert got.encode() == want.encode()


def test_split_plan_hands_the_inner_loop_to_the_decode_tier():
    """A speculative (or macro) plan's k-step loop and its drafts belong
    to the decode tier; the prefill child gets a single-step sub-plan."""
    plan, ref_plan = _plans(
        step_id=3, prefill=[(1, 0, 8)], decode=[2], preempted=[],
        block_tables={1: [0], 2: [1]}, new_tokens={1: [5] * 8, 2: [6]},
        num_steps=3, speculative=True, decode_steps={2: 3},
        draft_tokens={2: [7, 8]})
    pre, dec = _emu_pair().split_plan(plan)
    assert pre.num_steps == 1 and not pre.speculative
    assert dec.num_steps == 3 and dec.speculative
    assert dec.draft_tokens == {2: [7, 8]}
    ref_pre, ref_dec = _emu_pair("ref").split_plan(ref_plan)
    assert (pre.encode(), dec.encode()) == (ref_pre.encode(),
                                            ref_dec.encode())


# -- residency and handoff counters --------------------------------------------

def test_decode_tier_swap_billed_at_decode_bandwidth():
    pre_dev = DeviceModel(t_fixed=0.0, t_prefill_tok=0.0, t_decode_seq=0.0,
                          t_block_entry=0.0, t_swap_block=1e-3)
    dec_dev = dataclasses.replace(pre_dev, t_swap_block=1e-5)
    be = HybridBackend(EmulatedBackend(pre_dev, sleep=False),
                       EmulatedBackend(dec_dev, sleep=False),
                       t_handoff_block=0.0)
    swap = {9: [(0, 0), (1, 1)]}
    untagged = StepPlan(1, [], [], [], swap_outs=dict(swap))
    tagged = StepPlan(1, [], [], [], swap_outs=dict(swap),
                      decode_tier_swaps=[9])
    assert be.step_cost(untagged) == pytest.approx(2e-3)   # prefill tier
    assert be.step_cost(tagged) == pytest.approx(2e-5)     # decode tier


def test_execute_updates_residency_and_handoff_counters():
    be = _emu_pair(t_handoff_block=1e-3)
    plan = StepPlan(1, [(1, 0, 16)], [], [], block_tables={1: [0, 1]},
                    new_tokens={1: [5] * 16}, prefill_done=[1])
    res = be.execute(plan)
    assert be._tier[1] == "decode"          # handed off at prefill end
    assert be.n_handoffs == 1 and be.n_handoff_blocks == 2
    assert res.wall_s == pytest.approx(16e-6 + 2e-3)   # prefill + handoff
    res2 = be.execute(StepPlan(2, [], [1], [], block_tables={1: [0, 1]},
                               new_tokens={1: [0]}))
    assert be._tier[1] == "decode"
    assert 1 in res2.tokens


def test_preempted_clears_residency():
    be = _emu_pair()
    be.execute(StepPlan(1, [(1, 0, 8)], [], [], block_tables={1: [0]},
                        new_tokens={1: [5] * 8}, prefill_done=[1]))
    assert be._tier[1] == "decode"
    be.execute(StepPlan(2, [], [], [1]))
    assert 1 not in be._tier


@pytest.mark.parametrize("copy_streams", (0, 2))
def test_physical_handoff_moves_pages_and_length(copy_streams):
    """At the prefill->decode transition the pages are copied into the
    decode tier at the same ids (at the next execute with the copy
    engine) with the sequence length, and forgotten on the prefill tier."""
    kw = dict(block_size=8, num_blocks=16, vocab=64,
              copy_streams=copy_streams)
    pre = TorchBackend(device="cpu", **kw)
    be = HybridBackend(pre, CpuDecodeBackend(**kw),
                       copy_streams=copy_streams)
    toks = [3 + i for i in range(13)]
    be.execute(StepPlan(1, [(7, 0, 13)], [], [], block_tables={7: [4, 9]},
                        new_tokens={7: toks}, prefill_done=[7]))
    if copy_streams:
        assert not be.decode_backend.k_pages.any()    # deferred
        be.execute(StepPlan(2, [], [], []))           # epoch boundary
    dec = be.decode_backend
    assert torch.equal(dec.k_pages[:, [4, 9]], pre.k_pages[:, [4, 9]])
    assert torch.equal(dec.v_pages[:, [4, 9]], pre.v_pages[:, [4, 9]])
    assert dec._seq_lens.get(7) == 13 and 7 not in pre._seq_lens
    assert (be.n_handoffs, be.n_handoff_blocks) == (1, 2)


# -- make_backend --------------------------------------------------------------

def test_make_backend_hybrid_pairs(monkeypatch):
    cfg = SchedulerConfig(kv_capacity_tokens=64 * 8, block_size=8)
    # a narrow stand-in arch: drawing qwen2-0.5b's 151,936-row weights
    # takes seconds per leaf
    monkeypatch.setitem(ARCH_WIDTHS, "narrow", dict(
        n_heads=6, n_kv_heads=3, head_dim=32, vocab=300))
    hy = make_backend("hybrid", scheduler_cfg=cfg, prefill_backend="torch",
                      decode_backend="cpu", torch_device="cpu",
                      kv_dtype="int8")
    assert isinstance(hy, HybridBackend)
    assert isinstance(hy.prefill_backend, TorchBackend)
    assert isinstance(hy.decode_backend, CpuDecodeBackend)
    assert hy.prefill_backend.num_blocks == cfg.num_kv_blocks
    # int8 on the decode tier only: the handoff copy quantizes
    assert hy.prefill_backend.kv_dtype == "float32"
    assert hy.decode_backend.kv_dtype == "int8"
    wide = make_backend("hybrid", scheduler_cfg=cfg, prefill_backend="torch",
                        decode_backend="cpu", torch_device="cpu",
                        arch="narrow")
    # both tiers at the arch's widths, so pages can be handed across
    for child in (wide.prefill_backend, wide.decode_backend):
        assert (child.n_heads, child.n_kv_heads, child.head_dim,
                child.vocab) == (6, 3, 32, 300)

    dev = DeviceModel()
    hy2 = make_backend("hybrid", device=dev, scheduler_cfg=cfg,
                       decode_slowdown=4.0)
    assert isinstance(hy2.decode_backend, EmulatedBackend)
    assert hy2.decode_backend.device.t_decode_seq == \
        pytest.approx(dev.t_decode_seq * 4.0)
    assert hy2.prefill_backend.device is dev
    assert hy2.t_handoff_block == dev.t_swap_block
    with pytest.raises(ValueError):
        make_backend("hybrid", prefill_backend="hybrid")
    # mixed emulated/physical pairs would decode an all-zero pool (or
    # emit placeholder tokens after the first): rejected
    with pytest.raises(ValueError):
        make_backend("hybrid", scheduler_cfg=cfg,
                     prefill_backend="emulated", decode_backend="cpu")
    with pytest.raises(ValueError):
        make_backend("hybrid", scheduler_cfg=cfg, prefill_backend="torch",
                     decode_backend="emulated", torch_device="cpu")


# -- the int8 seam ---------------------------------------------------------------

def test_int8_handoff_quantizes_at_the_seam():
    """The fp32 prefill tier's pages land on an int8 decode tier quantized
    whole-page, within half an LSB, with the reference's codes and scales
    for the reference's pages."""
    pre = TorchBackend(block_size=8, num_blocks=8, device="cpu")
    dec = CpuDecodeBackend(block_size=8, num_blocks=8, kv_dtype="int8")
    pre._write([([2, 3], 0, list(range(3, 19)))])
    dec.import_pages([2, 3], *pre.export_pages([2, 3]))
    assert dec.k_pages.dtype == torch.int8
    kf, vf = pre._gather_pages(torch.tensor([2, 3]))
    kq, vq = dec._gather_pages(torch.tensor([2, 3]))
    for got, want, scales in ((kq, kf, dec.k_scales), (vq, vf, dec.v_scales)):
        lsb = scales[:, [2, 3]][:, :, None, None] / 127.0
        assert torch.all((got - want).abs() <= lsb + 1e-7)

    ref_pre = JaxBackend(block_size=8, num_blocks=8)
    ref_dec = RefCpuDecode(block_size=8, num_blocks=8, kv_dtype="int8")
    ref_pre._write([2, 3], 0, np.arange(3, 19))
    k, v = ref_pre.export_pages([2, 3])
    ref_dec.import_pages([2, 3], k, v)
    dec.import_pages([2, 3], torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(dec.k_pages[:, :8].numpy(),
                                  ref_dec.k_pages)
    np.testing.assert_array_equal(dec.v_scales[:, :8].numpy(),
                                  ref_dec.v_scales)


# -- lockstep against repro's hybrid -------------------------------------------

LOCKSTEP = {
    "k1": ("k1", {}),
    "k4": ("k4", {}),
    "swap_streams0": ("swap_streams0", {}),
    "swap_streams2_k4": ("swap_streams2_k4", {}),
    "int8_decode_tier": ("k1", {"kv_dtype": "int8"}),
    "int8_swap_k4": ("int8_swap_k4", {}),
}


def _hybrid_pair(cfg, kv_dtype):
    kw = dict(block_size=cfg.block_size, num_blocks=cfg.num_kv_blocks,
              num_swap_blocks=cfg.num_swap_blocks,
              copy_streams=cfg.copy_streams, vocab=VOCAB)
    jpre = JaxBackend(interpret=True, **kw)
    ref = RefHybrid(jpre, RefCpuDecode(kv_dtype=kv_dtype, **kw),
                    t_handoff_block=1e-6, copy_streams=cfg.copy_streams)
    port = HybridBackend(
        TorchBackend(device="cpu", params=_params(jpre), **kw),
        CpuDecodeBackend(kv_dtype=kv_dtype, **kw),
        t_handoff_block=1e-6, copy_streams=cfg.copy_streams)
    return ref, port


@pytest.mark.parametrize("name", sorted(LOCKSTEP))
def test_lockstep_with_the_reference_hybrid(name):
    case, over = LOCKSTEP[name]
    cfg_kw, specs, kv_dtype = CASES[case]
    kv_dtype = over.get("kv_dtype", kv_dtype)
    jreqs, treqs, tsched, tbe, macros = drive_lockstep(
        cfg_kw, specs, lambda cfg: _hybrid_pair(cfg, kv_dtype))
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert any(t != 0 for r in treqs for t in r.generated)
    assert tbe.n_handoffs == len(specs) + sum(r.n_preemptions for r in treqs)
    assert tsched.blocks.free_blocks == tsched.blocks.num_blocks
    if case.startswith("swap") or case.endswith("swap_k4"):
        assert sum(r.n_swaps + r.n_preemptions for r in treqs) >= 1
    if case.endswith("k4"):
        assert macros >= 1


def test_serve_cli_hybrid_on_cpu():
    proc = _serve("--backend", "hybrid", "--prefill-backend", "torch",
                  "--decode-backend", "cpu", "--device", "cpu",
                  "--kv-dtype", "int8", "--tp", "2", "--cores", "2",
                  "--requests", "4", "--rps", "50", "--words", "30",
                  "--max-new", "4")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[serve] completed 4/4" in proc.stdout
    assert "[serve] worker0 handoffs=4 handoff_blocks=" in proc.stdout
    assert "[serve] workers=2 kernel_launches=0" in proc.stdout
