"""The port's speculative decode against ``repro``'s and against itself.

Twins of tests/test_spec_decode.py's backend tests on
``repro_torch.spec.SpeculativeBackend`` and the surrogate's batched
verify: greedy speculative decoding is token-identical to stepwise greedy
decoding on every target (the torch leaf on the CPU, the cpu leaf, the
hybrid), with and without the copy engine, under swap pressure, with a
draft that guesses wrong, with EOS inside an accepted run and with
prefill chunks in flight; an int8 decode tier is deterministic from run to
run.  Then lockstep: ``repro``'s ``SpeculativeBackend(CpuDecodeBackend ->
JaxBackend)`` under ``repro``'s scheduler and the port's
``SpeculativeBackend(CpuDecodeBackend -> TorchBackend on the CPU)`` under
the port's must broadcast the same plan bytes and emit the same token
stream at every step.  The serve CLI runs ``--speculative-k 4`` once as a
subprocess.
"""
from __future__ import annotations

import pytest

from repro.backend.cpu_decode import CpuDecodeBackend as RefCpuDecode
from repro.backend.emulated import EmulatedBackend as RefEmulated
from repro.backend.hybrid import HybridBackend as RefHybrid
from repro.backend.jax_backend import JaxBackend
from repro.core.devmodel import DeviceModel as RefDeviceModel
from repro.serving.scheduler import StepPlan as RefStepPlan
from repro.spec import SpeculativeBackend as RefSpeculative
from repro_torch.backend import make_backend
from repro_torch.backend.cpu_decode import CpuDecodeBackend
from repro_torch.backend.emulated import EmulatedBackend
from repro_torch.backend.hybrid import HybridBackend
from repro_torch.backend.torch_backend import TorchBackend
from repro_torch.core.devmodel import DeviceModel
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig, StepPlan
from repro_torch.spec import SpeculativeBackend
from test_torch_backend import _params, drive_lockstep
from test_torch_engine import _serve

BLOCK = 8
TARGETS = ("torch", "cpu", "hybrid")


def _cfg(spec_k: int = 0, *, blocks: int = 64, **kw) -> SchedulerConfig:
    kw.setdefault("prefill_chunk", 16)
    return SchedulerConfig(
        max_num_seqs=8, max_tokens_per_step=64,
        block_size=BLOCK, kv_capacity_tokens=blocks * BLOCK,
        speculative_k=spec_k, **kw)


def _kw(cfg: SchedulerConfig, **extra) -> dict:
    return dict(block_size=cfg.block_size, num_blocks=cfg.num_kv_blocks,
                num_swap_blocks=max(cfg.num_swap_blocks, 1), vocab=128,
                copy_streams=cfg.copy_streams, **extra)


def _target(name: str, cfg: SchedulerConfig, kv_dtype: str = "float32"):
    if name == "torch":
        return TorchBackend(device="cpu", **_kw(cfg, kv_dtype=kv_dtype))
    if name == "cpu":
        return CpuDecodeBackend(**_kw(cfg, kv_dtype=kv_dtype))
    if name == "hybrid":
        return HybridBackend(TorchBackend(device="cpu", **_kw(cfg)),
                             CpuDecodeBackend(**_kw(cfg, kv_dtype=kv_dtype)),
                             t_handoff_block=1e-6,
                             copy_streams=cfg.copy_streams)
    raise AssertionError(name)


def _spec(name: str, cfg: SchedulerConfig, kv_dtype: str = "float32",
          draft_seed: int | None = None) -> SpeculativeBackend:
    kw = _kw(cfg)
    if draft_seed is not None:
        kw["seed"] = draft_seed
    return SpeculativeBackend(CpuDecodeBackend(**kw),
                              _target(name, cfg, kv_dtype))


def _req(n: int, max_new: int, stream: int = 1, eos: int = None) -> Request:
    r = Request(text="", max_new_tokens=max_new)
    r.prompt_tokens = [3 + (((stream << 10) + j) % 100) for j in range(n)]
    r.eos_token = eos
    return r


def _drive(backend, cfg: SchedulerConfig, reqs, max_plans: int = 500):
    """Run to completion; returns (token streams, n_spec_plans, plans)."""
    sched = Scheduler(cfg)
    for r in reqs:
        sched.add_request(r)
    plans, seen = 0, []
    while sched.has_work and plans < max_plans:
        plan = sched.schedule()
        if plan is None:
            break
        plans += 1
        seen.append(plan)
        for req in sched.complete_step(plan, float(plans),
                                       backend.execute(plan)):
            backend.release(req.req_id)
    assert all(r.state == RequestState.FINISHED for r in reqs)
    assert sched.blocks.free_blocks == sched.blocks.num_blocks
    return ([list(r.generated) for r in reqs],
            sum(p.speculative for p in seen), seen)


def _stepwise(cfg: SchedulerConfig, reqs):
    """The oracle: stepwise greedy decode on the cpu leaf, no drafts."""
    toks, specs, _ = _drive(CpuDecodeBackend(**_kw(cfg)), cfg, reqs)
    assert specs == 0
    return toks


# -- bit-identity -------------------------------------------------------------

def _pressure_cfg(spec_k: int, copy_streams: int) -> SchedulerConfig:
    return SchedulerConfig(
        max_num_seqs=8, max_tokens_per_step=64, prefill_chunk=16,
        enable_prefix_cache=False, block_size=BLOCK,
        kv_capacity_tokens=12 * BLOCK,       # pressure: forces swap churn
        preemption_policy="swap", swap_capacity_tokens=32 * BLOCK,
        copy_streams=copy_streams, speculative_k=spec_k)


def _pressure_reqs():
    return [_req(n, m, stream=i + 1)
            for i, (n, m) in enumerate([(12, 12), (20, 9), (9, 12)])]


@pytest.fixture(scope="module")
def pressure_oracle():
    return _stepwise(_pressure_cfg(0, 0), _pressure_reqs())


@pytest.mark.parametrize("name", TARGETS)
@pytest.mark.parametrize("streams", (0, 2))
def test_spec_bit_identical_to_stepwise_under_pressure(name, streams,
                                                       pressure_oracle):
    cfg = _pressure_cfg(4, streams)
    sb = _spec(name, cfg)
    toks, specs, _ = _drive(sb, cfg, _pressure_reqs())
    assert specs >= 1, "no speculative plan fired"
    assert toks == pressure_oracle
    assert sb.n_accepted == sb.n_drafted     # same weights: drafts all hit


def test_emulated_spec_keeps_the_stream_shape(pressure_oracle):
    dev = DeviceModel(t_fixed=1e-5, t_prefill_tok=1e-8, t_decode_seq=1e-6)
    cfg = _pressure_cfg(4, 0)
    sb = SpeculativeBackend(EmulatedBackend(dev, sleep=False),
                            EmulatedBackend(dev, sleep=False))
    toks, specs, _ = _drive(sb, cfg, _pressure_reqs())
    assert specs >= 1
    assert [len(t) for t in toks] == [len(t) for t in pressure_oracle]


def test_divergent_draft_still_bit_identical():
    """A draft with other weights proposes wrong tokens; verification
    rejects them and the stream is still stepwise greedy decode's."""
    reqs = lambda: [_req(12, 10, 1), _req(9, 8, 2)]
    oracle = _stepwise(_cfg(0), reqs())
    cfg = _cfg(spec_k=4)
    sb = _spec("torch", cfg, draft_seed=7)
    toks, specs, _ = _drive(sb, cfg, reqs())
    assert specs >= 1
    assert toks == oracle
    assert sb.n_accepted < sb.n_drafted      # the draft really is bad


def test_spec_eos_truncation_matches_stepwise():
    base = _stepwise(_cfg(0), [_req(12, 10, 1)])
    eos = base[0][len(base[0]) // 2]         # a token mid-stream
    oracle = _stepwise(_cfg(0), [_req(12, 10, 1, eos=eos)])
    assert len(oracle[0]) < len(base[0])     # it actually truncated
    toks, specs, _ = _drive(_spec("torch", _cfg(4)), _cfg(4),
                            [_req(12, 10, 1, eos=eos)])
    assert specs >= 1
    assert toks == oracle


def test_spec_with_prefill_in_flight():
    reqs = lambda: [_req(40, 8, 1), _req(24, 6, 2)]
    oracle = _stepwise(_cfg(0), reqs())
    cfg = _cfg(4, per_tier_macros=True, prefill_chunk=8)
    toks, specs, seen = _drive(_spec("torch", cfg), cfg, reqs())
    assert specs >= 1
    assert toks == oracle
    assert any(p.speculative and p.prefill for p in seen), \
        "no speculative plan carried a prefill chunk"


def test_spec_int8_deterministic():
    """An int8 decode tier may differ from the fp32 stream (quantized
    logits), but it is the same from run to run."""
    runs = []
    for _ in range(2):
        cfg = _cfg(4)
        toks, specs, _ = _drive(_spec("hybrid", cfg, kv_dtype="int8"), cfg,
                                [_req(12, 8, 1), _req(9, 6, 2)])
        assert specs >= 1
        runs.append(toks)
    assert runs[0] == runs[1]


def test_verify_scores_every_row_in_one_attend():
    """One verify step: the inputs' K/V is written once, every (request,
    position) row goes through one ``_attend``, and the emitted stream is
    the accepted drafts plus the correction token."""
    be = CpuDecodeBackend(block_size=8, num_blocks=8, vocab=128)
    calls = []
    attend = be._attend
    be._attend = lambda q, bt, sl: calls.append(sl.tolist()) or attend(
        q, bt, sl)
    be.execute(StepPlan(1, [(1, 0, 5)], [], [], block_tables={1: [2]},
                        new_tokens={1: [9, 8, 7, 6, 5]}))
    greedy = CpuDecodeBackend(block_size=8, num_blocks=8, vocab=128)
    greedy.execute(StepPlan(1, [(1, 0, 5)], [], [], block_tables={1: [2]},
                            new_tokens={1: [9, 8, 7, 6, 5]}))
    truth = greedy._decode_multi([1], {1: [2]}, {1: 5}, {1: 4}, {1: 3},
                                 {1: None}, 3)
    t = [row[1] for row in truth]
    calls.clear()
    plan = StepPlan(2, [], [1], [], block_tables={1: [2]},
                    new_tokens={1: [4]}, num_steps=3, speculative=True,
                    decode_steps={1: 3}, draft_tokens={1: [t[0], t[1] + 1]})
    res = be.execute(plan)
    assert calls == [[6, 7, 8]]              # one attend, three rows
    assert [row[1] for row in res.token_steps] == t[:2]   # d_2 rejected


# -- lockstep against repro's speculative backend ------------------------------

LOCKSTEP = {
    "k4": dict(prefill_chunk=16, enable_prefix_cache=True,
               kv_capacity_tokens=64 * BLOCK),
    "k3_swap_streams2": dict(prefill_chunk=16, enable_prefix_cache=False,
                             kv_capacity_tokens=12 * BLOCK,
                             preemption_policy="swap",
                             swap_capacity_tokens=32 * BLOCK,
                             copy_streams=2),
    "k4_per_tier": dict(prefill_chunk=8, enable_prefix_cache=True,
                        kv_capacity_tokens=64 * BLOCK, per_tier_macros=True),
}
WORKLOAD = [(40, 12, 1), (21, 9, 2), (9, 12, 3)]


def _spec_pair(cfg, target: str):
    kw = dict(block_size=cfg.block_size, num_blocks=cfg.num_kv_blocks,
              num_swap_blocks=cfg.num_swap_blocks,
              copy_streams=cfg.copy_streams, vocab=128)
    jbe = JaxBackend(interpret=True, **kw)
    params = _params(jbe)
    if target == "hybrid":
        ref_t = RefHybrid(jbe, RefCpuDecode(**kw), t_handoff_block=1e-6,
                          copy_streams=cfg.copy_streams)
        port_t = HybridBackend(TorchBackend(device="cpu", params=params,
                                            **kw),
                               CpuDecodeBackend(**kw), t_handoff_block=1e-6,
                               copy_streams=cfg.copy_streams)
    else:
        ref_t, port_t = jbe, TorchBackend(device="cpu", params=params, **kw)
    return (RefSpeculative(RefCpuDecode(**kw), ref_t),
            SpeculativeBackend(CpuDecodeBackend(**kw), port_t))


@pytest.mark.parametrize("name,target", [(n, "torch") for n in LOCKSTEP]
                         + [("k4", "hybrid")])
def test_lockstep_with_the_reference_spec(name, target):
    k = 3 if name.startswith("k3") else 4
    cfg_kw = dict(LOCKSTEP[name], max_num_seqs=8, max_tokens_per_step=64,
                  block_size=BLOCK, speculative_k=k)
    jreqs, treqs, tsched, tbe, macros = drive_lockstep(
        cfg_kw, WORKLOAD, lambda cfg: _spec_pair(cfg, target))
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert macros >= 1 and tbe.n_spec_steps >= 1
    assert tsched.blocks.free_blocks == tsched.blocks.num_blocks


def test_synthesize_result_matches_the_reference():
    """The DES acceptance model (emulated children): per row, 1 +
    round(accept_rate * (budget - 1)) placeholder tokens."""
    fields = dict(step_id=4, prefill=[(7, 0, 8)], decode=[1, 2], preempted=[],
                  num_steps=5, speculative=True, decode_steps={1: 5, 2: 2})
    dev = dict(t_fixed=1e-5, t_prefill_tok=1e-8, t_decode_seq=1e-6)
    port = SpeculativeBackend(EmulatedBackend(DeviceModel(**dev)),
                              EmulatedBackend(DeviceModel(**dev)),
                              accept_rate=0.6)
    ref = RefSpeculative(RefEmulated(RefDeviceModel(**dev)),
                         RefEmulated(RefDeviceModel(**dev)), accept_rate=0.6)
    got = port.synthesize_result(StepPlan(**fields))
    want = ref.synthesize_result(RefStepPlan(**fields))
    assert got.token_steps == want.token_steps
    assert got.tokens == want.tokens
    assert got.wall_s == pytest.approx(want.wall_s)
    assert port.synthesize_result(StepPlan(1, [], [1], [])) is None


def test_make_backend_speculative():
    cfg = _cfg(3)
    sb = make_backend("torch", scheduler_cfg=cfg, torch_device="cpu")
    assert isinstance(sb.target, TorchBackend)
    assert isinstance(sb.draft, CpuDecodeBackend)
    assert sb.draft.kv_dtype == "float32"
    hy = make_backend("hybrid", scheduler_cfg=cfg, prefill_backend="torch",
                      decode_backend="cpu", torch_device="cpu",
                      kv_dtype="int8")
    assert isinstance(hy.target, HybridBackend)
    assert hy.draft.kv_dtype == "float32"     # the draft pool stays fp32
    emu = make_backend("emulated", scheduler_cfg=cfg, spec_accept_rate=0.5)
    assert isinstance(emu.draft, EmulatedBackend) and emu.accept_rate == 0.5
    # a draft's physicality must match its target's
    with pytest.raises(ValueError):
        make_backend("torch", scheduler_cfg=cfg, torch_device="cpu",
                     draft_backend="emulated")
    with pytest.raises(ValueError):
        make_backend("emulated", scheduler_cfg=cfg, draft_backend="cpu")
    with pytest.raises(ValueError):
        make_backend("torch", scheduler_cfg=cfg, torch_device="cpu",
                     draft_backend="jax")


def test_serve_cli_speculative_on_cpu():
    proc = _serve("--backend", "torch", "--speculative-k", "4",
                  "--draft-backend", "cpu", "--device", "cpu", "--tp", "2",
                  "--cores", "2", "--requests", "4", "--rps", "50",
                  "--words", "30", "--max-new", "9")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[serve] completed 4/4" in proc.stdout
    assert "[serve] worker0 spec_steps=" in proc.stdout
    assert "[serve] workers=2 kernel_launches=0" in proc.stdout
