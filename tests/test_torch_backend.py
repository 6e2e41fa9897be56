"""The port's TorchBackend and Scheduler against the JAX package.

Each workload runs twice in lockstep: ``repro``'s Scheduler driving
``JaxBackend`` (the Pallas kernel in interpret mode), and ``repro_torch``'s
Scheduler driving ``TorchBackend`` on the CPU (the kernel's plain version),
with the JAX backend's weight arrays carried across.  Every step must give
byte-identical ``StepPlan.encode()`` payloads and identical sampled
tokens, for k=1, k=4 macro-plans, swap-pressure churn with and without the
async copy engine, and int8 pools.  The workloads and scheduler configs
are those of tests/test_backend_conformance.py and tests/test_multi_step.py.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.backend.cpu_decode import CpuDecodeBackend
from repro.backend.jax_backend import JaxBackend
from repro.configs.qwen2_0_5b import CONFIG as QWEN2_0_5B
from repro.serving.request import Request as JaxRequest
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro.serving.scheduler import SchedulerConfig as JaxSchedulerConfig
from repro_torch.backend import ARCH_WIDTHS, make_backend
from repro_torch.backend.surrogate import draw_params
from repro_torch.backend.torch_backend import TorchBackend
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import (Scheduler, SchedulerConfig,
                                           StepPlan)

BLOCK, VOCAB = 8, 128
_BASE = dict(max_num_seqs=8, max_tokens_per_step=64, prefill_chunk=16,
             block_size=BLOCK)
# conformance workload: (prompt length, max_new, token stream)
CONFORMANCE = [(21, 3, 1), (40, 5, 2), (21, 2, 1), (9, 4, 3)]
CHURN = [(40, 24, 1), (37, 24, 2)]
CASES = {
    "k1": (dict(_BASE, enable_prefix_cache=True,
                kv_capacity_tokens=64 * BLOCK), CONFORMANCE, "float32"),
    "k4": (dict(_BASE, enable_prefix_cache=True,
                kv_capacity_tokens=64 * BLOCK, max_steps_per_dispatch=4),
           CHURN, "float32"),
    "swap_streams0": (dict(_BASE, enable_prefix_cache=False,
                           kv_capacity_tokens=12 * BLOCK,
                           preemption_policy="swap",
                           swap_capacity_tokens=32 * BLOCK, copy_streams=0),
                      CHURN, "float32"),
    "swap_streams2_k4": (dict(_BASE, enable_prefix_cache=False,
                              kv_capacity_tokens=12 * BLOCK,
                              preemption_policy="swap",
                              swap_capacity_tokens=32 * BLOCK,
                              copy_streams=2, max_steps_per_dispatch=4),
                         CHURN, "float32"),
    "int8": (dict(_BASE, enable_prefix_cache=True,
                  kv_capacity_tokens=64 * BLOCK), CONFORMANCE, "int8"),
    "int8_swap_k4": (dict(_BASE, enable_prefix_cache=False,
                          kv_capacity_tokens=12 * BLOCK,
                          preemption_policy="swap",
                          swap_capacity_tokens=32 * BLOCK,
                          max_steps_per_dispatch=4), CHURN, "int8"),
}


def _params(jbe: JaxBackend):
    return {"embed": jbe._embed, "wq": jbe._wq, "wk": jbe._wk,
            "wv": jbe._wv, "wo": jbe._wo}


def _pair(cfg, kv_dtype="float32", **kw):
    """A JaxBackend and a TorchBackend on the CPU with the same weights."""
    be_kw = dict(block_size=cfg.block_size, num_blocks=cfg.num_kv_blocks,
                 num_swap_blocks=cfg.num_swap_blocks,
                 copy_streams=cfg.copy_streams, vocab=VOCAB,
                 kv_dtype=kv_dtype, **kw)
    jbe = JaxBackend(interpret=True, **be_kw)
    return jbe, TorchBackend(device="cpu", params=_params(jbe), **be_kw)


def _requests(cls, specs):
    reqs = []
    for i, (n, max_new, stream) in enumerate(specs):
        r = cls(text="", max_new_tokens=max_new, req_id=1000 + i)
        r.prompt_tokens = [3 + (((stream << 10) + j) % 100) for j in range(n)]
        reqs.append(r)
    return reqs


def lockstep(case: str, max_steps: int = 500):
    """Drive both stacks in lockstep, asserting identical plan bytes and
    sampled tokens at every step; returns both sides' requests, the
    port's scheduler and backend, and the number of macro-plans."""
    cfg_kw, specs, kv_dtype = CASES[case]
    return drive_lockstep(cfg_kw, specs,
                          lambda cfg: _pair(cfg, kv_dtype), max_steps)


def drive_lockstep(cfg_kw: dict, specs, make_pair, max_steps: int = 500):
    """``lockstep`` for any pair of backends: ``make_pair(cfg)`` returns
    the reference's backend and the port's for the port's scheduler
    config ``cfg``."""
    jsched = JaxScheduler(JaxSchedulerConfig(**cfg_kw))
    tsched = Scheduler(SchedulerConfig(**cfg_kw))
    jbe, tbe = make_pair(tsched.cfg)
    jreqs, treqs = _requests(JaxRequest, specs), _requests(Request, specs)
    for jr, tr in zip(jreqs, treqs):
        jsched.add_request(jr)
        tsched.add_request(tr)
    step = macros = 0
    while tsched.has_work and step < max_steps:
        jplan, tplan = jsched.schedule(), tsched.schedule()
        assert (jplan is None) == (tplan is None)
        if tplan is None:
            break
        step += 1
        macros += tplan.num_steps > 1
        assert tplan.encode() == jplan.encode(), f"plan {step} differs"
        jres, tres = jbe.execute(jplan), tbe.execute(tplan)
        assert tres.tokens == jres.tokens, f"tokens differ at plan {step}"
        assert tres.token_steps == jres.token_steps
        for sched, plan, res, be in ((jsched, jplan, jres, jbe),
                                     (tsched, tplan, tres, tbe)):
            for req in sched.complete_step(plan, float(step), res):
                be.release(req.req_id)
    assert not jsched.has_work
    assert all(r.state == RequestState.FINISHED for r in treqs)
    return jreqs, treqs, tsched, tbe, macros


@pytest.mark.parametrize("case", sorted(CASES))
def test_token_streams_identical_to_jax_backend(case):
    jreqs, treqs, tsched, tbe, macros = lockstep(case)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert any(t != 0 for r in treqs for t in r.generated)
    assert tsched.blocks.free_blocks == tsched.blocks.num_blocks
    if case.startswith("swap") or case.endswith("swap_k4"):
        assert sum(r.n_swaps + r.n_preemptions for r in treqs) >= 1, \
            "workload must churn the KV pool"
    if case.endswith("k4"):
        assert macros >= 1, "steady tail must have fired a macro-plan"
    # no per-request state survives the drained workload
    assert not tbe._seq_lens and not tbe._swap_pinned


def test_scheduler_plan_bytes_identical_without_a_backend():
    """The copied scheduler on its own: the same workload, completed with
    the emulated placeholder tokens, broadcasts the same bytes."""
    cfg_kw, specs, _ = CASES["swap_streams2_k4"]
    jsched = JaxScheduler(JaxSchedulerConfig(**cfg_kw))
    tsched = Scheduler(SchedulerConfig(**cfg_kw))
    for jr, tr in zip(_requests(JaxRequest, specs),
                      _requests(Request, specs)):
        jsched.add_request(jr)
        tsched.add_request(tr)
    n = 0
    while tsched.has_work and n < 500:
        jplan, tplan = jsched.schedule(), tsched.schedule()
        if tplan is None:
            assert jplan is None
            break
        n += 1
        assert tplan.encode() == jplan.encode()
        jsched.complete_step(jplan, float(n))
        tsched.complete_step(tplan, float(n))
    assert n > 10 and not jsched.has_work


@pytest.mark.parametrize("kv_dtype", ("float32", "int8"))
def test_attend_logits_agree(kv_dtype):
    """After the same prefill, ``_attend`` over the same queries, tables
    and lengths gives the same logits (1e-4) and the same pools."""
    cfg = SchedulerConfig(**CASES["k1"][0])
    jbe, tbe = _pair(cfg, kv_dtype)
    toks = [3 + (i * 7) % 90 for i in range(29)]
    for be in (jbe, tbe):
        be.execute(StepPlan(1, [(1, 0, 29)], [], [],
                            block_tables={1: [5, 2, 9, 11]},
                            new_tokens={1: toks}))
    n = cfg.num_kv_blocks
    if kv_dtype == "int8":
        # same write order, same requant-on-growth: codes agree to one
        # step (a last-bit difference in a projection may round one code
        # the other way) and scales to float32 rounding
        np.testing.assert_allclose(tbe.k_scales[:, :n].numpy(),
                                   jbe.k_scales, rtol=1e-6)
        assert np.abs(tbe.k_pages[:, :n].numpy().astype(int)
                      - jbe.k_pages.astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(tbe.k_pages[:, :n].numpy(), jbe.k_pages,
                                   atol=1e-6, rtol=1e-6)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    bt = np.array([[5, 2, 9, 11], [5, 2, -1, -1], [9, -1, -1, -1]],
                  np.int32)
    # no fully masked row: the JAX backend clamps -1 to page 0 of its
    # compact pool, the port to page 0 of the whole pool, so such rows
    # (never sampled) average different pages
    sl = np.array([29, 13, 6], np.int32)
    want = jbe._attend(q, bt, sl)
    got = tbe._attend(torch.from_numpy(q), torch.from_numpy(bt),
                      torch.from_numpy(sl)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kv_dtype", ("float32", "int8"))
@pytest.mark.parametrize("copy_streams", (0, 2))
def test_swap_round_trip_restores_identical_pages(kv_dtype, copy_streams):
    """swap_outs apply before restores and compute: a device block parked
    on host and clobbered by a prefill in the SAME plan restores
    bit-identical (with the copy engine, at the next epoch boundary)."""
    be = TorchBackend(block_size=8, num_blocks=16, num_swap_blocks=8,
                      vocab=64, kv_dtype=kv_dtype, copy_streams=copy_streams,
                      device="cpu")
    toks = [3 + (i % 60) for i in range(16)]
    be.execute(StepPlan(1, [(1, 0, 16)], [], [],
                        block_tables={1: [3, 7]}, new_tokens={1: toks}))
    snap_k = be.k_pages[:, [3, 7]].clone()
    snap_v = be.v_pages[:, [3, 7]].clone()
    snap_s = None if be.k_scales is None else be.k_scales[:, [3, 7]].clone()
    assert snap_k.abs().sum() > 0
    clobber = [60 - (i % 50) for i in range(16)]
    if copy_streams:
        # deferred: the swap-out lands at the next epoch boundary, and the
        # scheduler's in-flight holds keep blocks 3/7 unreallocated
        be.execute(StepPlan(2, [], [], [], swap_outs={1: [(3, 0), (7, 1)]}))
        be.execute(StepPlan(3, [(2, 0, 16)], [], [],
                            block_tables={2: [3, 7]},
                            new_tokens={2: clobber}))
    else:
        be.execute(StepPlan(2, [(2, 0, 16)], [], [],
                            block_tables={2: [3, 7]}, new_tokens={2: clobber},
                            swap_outs={1: [(3, 0), (7, 1)]}))
    assert not torch.equal(be.k_pages[:, [3, 7]], snap_k)      # clobbered
    assert torch.equal(be.k_swap[:, [0, 1]], snap_k)
    be.execute(StepPlan(4, [], [], [], restores={1: [(0, 10), (1, 11)]}))
    be.execute(StepPlan(5, [], [], []))        # epoch boundary (deferred)
    assert torch.equal(be.k_pages[:, [10, 11]], snap_k)
    assert torch.equal(be.v_pages[:, [10, 11]], snap_v)
    if kv_dtype == "int8":                     # scales move with pages
        assert torch.equal(be.k_scales[:, [10, 11]], snap_s)


def test_import_pages_quantizes_like_the_reference():
    """The whole-page fp32 -> int8 conversion of the handoff copy gives
    the reference's codes and scales exactly (same inputs, same ops)."""
    rng = np.random.default_rng(9)
    k = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    v = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
    ref = CpuDecodeBackend(block_size=8, num_blocks=8, vocab=64,
                           kv_dtype="int8")
    port = TorchBackend(block_size=8, num_blocks=8, vocab=64,
                        kv_dtype="int8", device="cpu")
    ref.import_pages([1, 4, 6], k, v)
    port.import_pages([1, 4, 6], torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(port.k_pages[:, :8].numpy(), ref.k_pages)
    np.testing.assert_array_equal(port.v_pages[:, :8].numpy(), ref.v_pages)
    np.testing.assert_array_equal(port.k_scales[:, :8].numpy(), ref.k_scales)
    ek, ev = port.export_pages([1, 4, 6])
    rk, rv = ref.export_pages([1, 4, 6])
    np.testing.assert_array_equal(ek.numpy(), rk)
    np.testing.assert_array_equal(ev.numpy(), rv)


def test_weights_drawn_as_the_reference_draws_them():
    jbe = JaxBackend(block_size=8, num_blocks=4, vocab=VOCAB)
    drawn = draw_params(vocab=VOCAB, n_heads=4, n_kv_heads=2, head_dim=16,
                        seed=0)
    for key, arr in _params(jbe).items():
        np.testing.assert_array_equal(drawn[key], arr)
    tbe = TorchBackend(block_size=8, num_blocks=4, vocab=VOCAB, device="cpu")
    np.testing.assert_array_equal(tbe._wo.numpy(), jbe._wo)


def test_arch_widths_match_the_reference_config():
    w = ARCH_WIDTHS["qwen2-0.5b"]
    assert w["n_heads"] == QWEN2_0_5B.n_heads
    assert w["n_kv_heads"] == QWEN2_0_5B.n_kv_heads
    assert w["head_dim"] == QWEN2_0_5B.d_model // QWEN2_0_5B.n_heads
    assert w["vocab"] == QWEN2_0_5B.vocab_size


def test_make_backend_leaves(monkeypatch):
    cfg = SchedulerConfig(**CASES["k1"][0])
    be = make_backend("torch", scheduler_cfg=cfg, torch_device="cpu")
    assert isinstance(be, TorchBackend)
    assert be.num_blocks == cfg.num_kv_blocks
    assert (be.n_heads, be.n_kv_heads, be.head_dim, be.vocab) == (4, 2, 16,
                                                                  256)
    assert be.kernel_launches == 0            # CPU tensors: plain version
    from repro_torch.backend.cpu_decode import CpuDecodeBackend
    from repro_torch.backend.hybrid import HybridBackend
    from repro_torch.spec import SpeculativeBackend
    monkeypatch.setitem(ARCH_WIDTHS, "narrow", dict(
        n_heads=6, n_kv_heads=3, head_dim=32, vocab=300))
    cpu = make_backend("cpu", scheduler_cfg=cfg, arch="narrow")
    assert isinstance(cpu, CpuDecodeBackend)
    assert cpu.device == torch.device("cpu")
    assert (cpu.n_heads, cpu.n_kv_heads, cpu.vocab) == (6, 3, 300)
    assert isinstance(make_backend("hybrid", scheduler_cfg=cfg),
                      HybridBackend)
    spec = SchedulerConfig(**dict(CASES["k1"][0], speculative_k=2))
    sb = make_backend("torch", scheduler_cfg=spec, torch_device="cpu")
    assert isinstance(sb, SpeculativeBackend)
    assert isinstance(sb.target, TorchBackend)
    assert isinstance(sb.draft, CpuDecodeBackend)
    with pytest.raises(ValueError):
        make_backend("torch", scheduler_cfg=cfg, torch_device="cpu",
                     arch="no-such-model")
    with pytest.raises(ValueError):
        make_backend("jax", scheduler_cfg=cfg)
