"""The port's fleet against ``repro.fleet``.

Twins of tests/test_fleet.py, tests/test_fleet_conformance.py and
tests/test_fleet_drain.py that need no DES (the simulated fleet waits for
the port of ``repro.sim``): the prefix blooms set the reference's bits;
the router makes the reference's decision, with the reference's
counters, for the same snapshots, prompts, sessions, completions and
drains under every policy; the autoscaler recommends what the
reference's does for the same signals; a scheduler publishes the
reference's prefix summary after the same workload.  Then a live fleet:
two emulated replicas behind the frontend answer every request, and the
serve CLI runs ``--replicas 2`` once as a subprocess.
"""
from __future__ import annotations

import random

import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container ships no hypothesis — deterministic sweep
    from _hypothesis_fallback import given, settings, strategies as st

from repro.fleet import AutoscalerConfig as RefAutoscalerConfig
from repro.fleet import FleetAutoscaler as RefAutoscaler
from repro.fleet import FleetRouter as RefRouter
from repro.fleet import PrefixSummary as RefPrefixSummary
from repro.fleet import ReplicaSignals as RefSignals
from repro.fleet import RouterConfig as RefRouterConfig
from repro.fleet import leading_block_keys as ref_block_keys
from repro.fleet import leading_word_keys as ref_word_keys
from repro.serving.request import Request as RefRequest
from repro.serving.scheduler import PressureStats as RefPressureStats
from repro.serving.scheduler import Scheduler as RefScheduler
from repro.serving.scheduler import SchedulerConfig as RefSchedulerConfig
from repro_torch.core.devmodel import DeviceModel
from repro_torch.core.engine import EngineConfig
from repro_torch.fleet import (POLICIES, AutoscalerConfig, FleetAutoscaler,
                               FleetRouter, FleetServingFrontend,
                               PrefixSummary, ReplicaSignals, RouterConfig,
                               leading_block_keys, leading_word_keys)
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import (PressureStats, Scheduler,
                                           SchedulerConfig)
from test_torch_engine import _serve


def _prompt(stream: int, n: int = 64):
    base = stream << 24
    return list(range(base, base + n))


# -- prefix summaries and keys -------------------------------------------------

@settings(max_examples=30, deadline=None, derandomize=True)
@given(st.lists(st.integers(min_value=-2**62, max_value=2**62),
                max_size=200))
def test_bloom_no_false_negatives_and_reference_bits(keys):
    s = PrefixSummary.from_keys(keys)
    assert all(s.might_contain(k) for k in keys)
    assert len(s) == len(keys)
    assert s.bits == RefPrefixSummary.from_keys(keys).bits


def test_chain_and_word_keys_match_the_reference():
    toks = _prompt(7, 200)
    for block, most in ((64, 8), (8, 8), (16, 3)):
        assert (leading_block_keys(toks, block, most)
                == ref_block_keys(toks, block, most))
    shared = "tok " * 64
    for text in (shared + "alpha beta " * 16, "too short"):
        assert leading_word_keys(text) == ref_word_keys(text)


# -- routing decisions ---------------------------------------------------------

def _snapshot(cls, summary_cls, rng: random.Random):
    keys = [ref_block_keys(_prompt(rng.randrange(6)), 8)[0]
            for _ in range(rng.randrange(3))]
    return cls(step_id=rng.randrange(100), free_blocks=rng.choice((0, 8, 64)),
               total_blocks=64, queue_depth=rng.randrange(20),
               n_running=rng.randrange(8), n_swapped=0, n_restoring=0,
               in_flight_copies=0, kv_used_tokens=rng.randrange(512),
               cached_blocks=len(keys), n_preempted=rng.randrange(3),
               n_timed_out=0, cpu_saturation=rng.random(),
               prefix_summary=(summary_cls.from_keys(keys) if keys
                               else None))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", (0, 1))
def test_routing_decisions_match_the_reference(policy, seed):
    """One seeded trace of routes (prompts from six streams, four sessions,
    exclusions), dispatches, completions, aborts, drains and undrains,
    with the replicas' pressure snapshots changing under the router: the
    port's router picks the reference's replica every time and keeps the
    reference's counters and books."""
    n = 3
    snaps = {"port": [None] * n, "ref": [None] * n}
    port = FleetRouter(n, RouterConfig(policy=policy, block_size=8,
                                       queue_norm=4.0),
                       stats_fns=[lambda i=i: snaps["port"][i]
                                  for i in range(n)])
    ref = RefRouter(n, RefRouterConfig(policy=policy, block_size=8,
                                       queue_norm=4.0),
                    stats_fns=[lambda i=i: snaps["ref"][i] for i in range(n)])
    rng = random.Random(seed)
    live, rid = [], 0
    for step in range(300):
        if step % 7 == 0:
            i = rng.randrange(n)
            state = rng.getstate()
            snaps["port"][i] = _snapshot(PressureStats, PrefixSummary, rng)
            rng.setstate(state)
            snaps["ref"][i] = _snapshot(RefPressureStats, RefPrefixSummary,
                                        rng)
        op = rng.randrange(10)
        if op < 4:
            prompt = _prompt(rng.randrange(6), rng.choice((16, 64, 200)))
            session = rng.choice((None, "a", "b", "c", "d"))
            exclude = tuple(rng.sample(range(n), rng.randrange(2)))
            got = port.route(prompt, session=session, exclude=exclude)
            assert got == ref.route(prompt, session=session, exclude=exclude)
            port.record_dispatch(rid, got)
            ref.record_dispatch(rid, got)
            live.append(rid)
            rid += 1
        elif op < 8 and live:
            done = live.pop(rng.randrange(len(live)))
            assert port.record_done(done) == ref.record_done(done)
        elif op == 8:
            i = rng.randrange(n)
            assert port.drain(i) == ref.drain(i)
        else:
            i = rng.randrange(n)
            port.undrain(i)
            ref.undrain(i)
        assert port.stats() == ref.stats()
        assert port.outstanding == ref.outstanding


@pytest.mark.parametrize("policy", POLICIES)
def test_router_drain_excludes_replica(policy):
    r = FleetRouter(3, RouterConfig(policy=policy, block_size=8))
    toks = list(range(128))
    placed = {}
    for rid in range(6):
        placed[rid] = r.route(toks, session="s")
        r.record_dispatch(rid, placed[rid])
    orphans = r.drain(1)
    assert set(orphans) == {rid for rid, i in placed.items() if i == 1}
    assert r.stats()["drained"] == [1] and r.stats()["inflight"][1] == 0
    for _ in range(20):
        assert r.route(toks, session="s") != 1
    for rid in orphans:                      # finishing late is a no-op
        assert r.record_done(rid) is None
    assert sum(r.stats()["inflight"]) == len(r.outstanding)
    r.drain(0)
    r.drain(2)
    assert r.route(toks) in (0, 1, 2)        # all drained: still routes


def test_autoscaler_recommends_what_the_reference_does():
    rng = random.Random(3)
    port = FleetAutoscaler(2, AutoscalerConfig(window=2, max_replicas=4))
    ref = RefAutoscaler(2, RefAutoscalerConfig(window=2, max_replicas=4))
    for _ in range(60):
        sig = dict(cpu_saturation=rng.choice((0.01, 0.5, 0.99)),
                   timeout_rate=rng.choice((0.0, 0.2)),
                   preempt_rate=rng.choice((0.0, 0.9)),
                   kv_pressure=rng.choice((0.1, 0.99)))
        got = port.observe([ReplicaSignals(**sig)] * port.n)
        want = ref.observe([RefSignals(**sig)] * ref.n)
        assert (got.action, got.target, got.reason) == (
            want.action, want.target, want.reason)
        if got.action != "hold":
            port.resize(got.target)
            ref.resize(want.target)


def test_scheduler_publishes_the_reference_prefix_summary():
    """After the same workload, ``pressure_stats(with_prefix_summary=True)``
    carries the reference's bloom over the resident prefix chain keys."""
    kw = dict(max_num_seqs=4, max_tokens_per_step=64, prefill_chunk=16,
              block_size=8, kv_capacity_tokens=64 * 8)
    port, ref = Scheduler(SchedulerConfig(**kw)), RefScheduler(
        RefSchedulerConfig(**kw))
    for sched, cls in ((port, Request), (ref, RefRequest)):
        for i in range(3):
            r = cls(text="", max_new_tokens=2, req_id=i)
            r.prompt_tokens = [3 + ((i % 2) * 50 + j) % 90 for j in range(40)]
            sched.add_request(r)
        step = 0
        while sched.has_work and step < 100:
            plan = sched.schedule()
            if plan is None:
                break
            step += 1
            sched.complete_step(plan, float(step))
    got = port.pressure_stats(with_prefix_summary=True)
    want = ref.pressure_stats(with_prefix_summary=True)
    assert got.prefix_summary is not None and len(got.prefix_summary) > 0
    assert got.prefix_summary.bits == want.prefix_summary.bits
    assert got.cached_blocks == want.cached_blocks
    off = Scheduler(SchedulerConfig(**dict(kw, enable_prefix_cache=False)))
    assert off.pressure_stats(with_prefix_summary=True).prefix_summary is None


# -- live fleet ------------------------------------------------------------------

def test_live_two_replica_emulated_fleet():
    cfg = EngineConfig(
        tp_degree=1, pool_width=2, backend="emulated", pressure_every=4,
        device=DeviceModel(t_fixed=1e-4, t_prefill_tok=1e-7,
                           t_decode_seq=1e-5),
        scheduler=SchedulerConfig(kv_capacity_tokens=4096, block_size=16),
        yield_every=64)
    fleet = FleetServingFrontend([cfg] * 2, routing="affinity").start()
    try:
        n = 8
        placed = [fleet.submit(f"session {i % 2} shared preamble " * 12
                               + f"question {i}", max_new_tokens=3,
                               session=i % 2)[1] for i in range(n)]
        results = fleet.collect(n, timeout=90.0)
        assert sorted(results) == list(range(n))
        for gid, rec in results.items():
            assert not rec["timed_out"] and rec["n_generated"] == 3
            assert rec["replica"] == placed[gid]
        # one session, one replica: its prefix and its stickiness agree
        assert len({placed[i] for i in range(0, n, 2)}) == 1
        assert fleet.router.outstanding == {}
    finally:
        stats = fleet.shutdown()
    assert [sorted(s["role"] for s in per) for per in stats] == [
        ["engine", "worker0"]] * 2


def test_serve_cli_fleet_on_cpu():
    proc = _serve("--backend", "torch", "--device", "cpu", "--replicas", "2",
                  "--tp", "1", "--routing", "affinity", "--cores", "2",
                  "--requests", "6", "--rps", "50", "--words", "30",
                  "--max-new", "3")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[fleet] completed 6/6" in proc.stdout
    assert "[fleet] routing=affinity per-replica requests=" in proc.stdout
    for idx in (0, 1):
        assert f"[fleet r{idx}] workers=1 kernel_launches=0" in proc.stdout
