"""The port's DES (``repro_torch.sim``) against ``repro.sim``.

Each case runs one workload builder of ``sim/serving.py`` through both
packages with the same parameters and holds the port to the reference
exactly: every request's timestamps, state and token count, the victims'
TTFTs and ``victim_stats``, CPU saturation, the step waits, the SLO
summary and, for a fleet, the router's counters, the drain log and the
autoscaler's actions.  The arithmetic is the same Python code on both
sides, so ``==`` with no tolerance.  The cases cover the attacker/victim
workload at three core counts, the multi-step, speculative (fp32 and
int8), hybrid, async-copy, SLO and speed-bump (``inject``) variants
through ``mixed_class_workload``, and ``FleetModel`` through both prefix
workloads, a drain and the autoscaler.  Sizes are the reference tests'
or smaller.
"""
from __future__ import annotations

import dataclasses
import itertools

import pytest

import repro.fleet.autoscale as ref_autoscale
import repro.serving.request as ref_request
import repro.sim.serving as ref_sim
import repro_torch.fleet.autoscale as port_autoscale
import repro_torch.serving.request as port_request
import repro_torch.sim.serving as port_sim


def _swap_base(S, cores=4):
    """A small KV pool under swap preemption, so that the copy, restore
    and preemption paths run."""
    return S.llama8b_tp4_params(cores, preemption_policy="swap",
                                kv_capacity_tokens=6144)


def _mixed(S, params):
    return S.mixed_class_workload(params, rps=6.0, duration=2.0,
                                  interactive_share=0.5,
                                  batch_tokens=3_000, batch_new_tokens=128,
                                  horizon=60.0)


def _attacker_victim(cores):
    def run(S, A):
        return S.attacker_victim_workload(
            S.llama8b_tp4_params(cores), attacker_rps=8,
            attacker_tokens=20_000, n_victims=2, duration=3.0,
            horizon=120.0), None
    return run


def _drain(S, A):
    fleet = S.FleetModel(S.llama8b_tp4_params(4), n_replicas=2,
                         routing="round-robin", route_quantum=0.05)
    for i in range(4):
        fleet.add_request(0.1 * i, 400, max_new_tokens=120, stream=i)
    fleet.drain_replica_at(1.0, 0)
    for i in range(6):
        fleet.add_request(1.0 + 0.05 * i, 400, max_new_tokens=8,
                          stream=16 + i)
    return fleet.run(horizon=60.0), fleet


def _autoscale(S, A):
    fleet = S.FleetModel(
        S.llama8b_tp4_params(1), n_replicas=1, routing="p2c",
        autoscaler=A.FleetAutoscaler(1, A.AutoscalerConfig(
            window=2, max_replicas=2)),
        autoscale_quantum=2.0)
    for i in range(24):
        fleet.add_request(i / 8.0, 2048, max_new_tokens=4, stream=1 + i)
    return fleet.run(horizon=60.0), fleet


CASES = {
    **{f"attacker_victim_{c}_cores": _attacker_victim(c) for c in (5, 8, 32)},
    "multi_step": lambda S, A: (_mixed(S, S.with_multi_step(
        _swap_base(S), k=4)), None),
    "speculative_fp32": lambda S, A: (_mixed(S, S.with_speculative(
        _swap_base(S), k=4, accept_rate=0.8)), None),
    "speculative_int8": lambda S, A: (_mixed(S, S.with_speculative(
        _swap_base(S), k=4, accept_rate=0.6, kv_dtype="int8")), None),
    "hybrid_decode": lambda S, A: (_mixed(S, S.with_hybrid_decode(
        _swap_base(S), decode_slowdown=4.0, max_decode_seqs=16)), None),
    "async_copies": lambda S, A: (_mixed(S, S.with_async_copies(
        _swap_base(S), copy_streams=2)), None),
    "slo": lambda S, A: (_mixed(S, S.with_slo(
        _swap_base(S), "interactive:0.5,batch:0.5")), None),
    "inject": lambda S, A: (_mixed(S, dataclasses.replace(
        S.with_async_copies(_swap_base(S, cores=2), copy_streams=2),
        inject="scheduler=5000,tokenize=200,block_alloc=50")), None),
    "fleet_prefix_affinity": lambda S, A: (S.fleet_prefix_workload(
        S.llama8b_tp4_params(4), n_replicas=2, routing="affinity",
        n_sessions=4, requests_per_session=3, prompt_tokens=2048,
        horizon=60.0), None),
    "fleet_open_prefix_p2c": lambda S, A: (S.fleet_open_prefix_workload(
        S.llama8b_tp4_params(4), n_replicas=2, routing="p2c", n_streams=4,
        rps=4.0, duration=3.0, prompt_tokens=2048, horizon=60.0), None),
    "fleet_drain": _drain,
    "fleet_autoscale": _autoscale,
}


def _signature(S, res, fleet) -> dict:
    reqs = [(r.req_id, r.t_arrival, r.t_tokenize_start, r.t_tokenize_done,
             r.t_first_scheduled, r.t_first_token, r.t_done, r.state.value,
             len(r.generated), r.n_preemptions, r.n_swaps, r.is_victim,
             r.slo.name if r.slo is not None else None)
            for r in res.requests]
    sig = {"requests": reqs, "victim_ttfts": res.victim_ttfts(),
           "saturation_s": res.saturation_s, "sim_time": res.sim_time,
           "sched_costs": res.sched_costs,
           "dequeue_waits": res.dequeue_waits,
           "barrier_waits": res.barrier_waits,
           "slo_summary": res.slo_summary(),
           "victim_stats": S.victim_stats(res, 200.0)}
    if hasattr(res, "router"):
        sig["router"] = res.router
        sig["per_replica"] = [len(r.requests) for r in res.per_replica]
    if fleet is not None:
        sig["drain_log"] = fleet.drain_log
        sig["scale_log"] = fleet.scale_log
    return sig


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_sim_equals_reference(case, monkeypatch):
    """Both packages number requests from 0, so request ids (which the
    router's books and the drain log hold) compare too."""
    sigs = []
    for S, A, req_mod in ((ref_sim, ref_autoscale, ref_request),
                          (port_sim, port_autoscale, port_request)):
        monkeypatch.setattr(req_mod, "_ids", itertools.count())
        sigs.append(_signature(S, *CASES[case](S, A)))
    ref, port = sigs
    assert ref["requests"], "the workload made no request"
    assert port == ref


def test_cases_reach_what_they_name(monkeypatch):
    """The variants are not vacuous: the port's run of each fires the
    mechanism it is named for (speculative and macro plans, hybrid
    handoffs, swaps, SLO classes, injected delay, a drain, a scale-up)."""
    monkeypatch.setattr(port_request, "_ids", itertools.count())
    S = port_sim
    m = S.ServingModel(S.with_speculative(_swap_base(S), k=4,
                                          kv_dtype="int8"))
    for i in range(3):
        m.add_request(0.0, 64, max_new_tokens=24, stream=i)
    m.run(horizon=60.0)
    assert sum(p.speculative for p in m._plans.values()) >= 1
    m = S.ServingModel(S.with_multi_step(_swap_base(S), k=4))
    for i in range(3):
        m.add_request(0.0, 64, max_new_tokens=24, stream=i)
    m.run(horizon=60.0)
    assert any(p.num_steps > 1 for p in m._plans.values())
    res, _ = CASES["async_copies"](S, port_autoscale)
    assert sum(r.n_swaps + r.n_preemptions for r in res.requests) > 0
    m = S.ServingModel(S.with_hybrid_decode(_swap_base(S)))
    m.add_request(0.0, 400, max_new_tokens=4)
    m.run(horizon=30.0)
    assert any(m.backend._handoff_blocks(p, p.block_tables)
               for p in m._plans.values())
    assert CASES["slo"](S, port_autoscale)[0].slo_summary()
    params = dataclasses.replace(_swap_base(S, cores=2),
                                 inject="scheduler=5000")
    m = S.ServingModel(params)
    m.add_request(0.0, 600, max_new_tokens=4)
    m.run(horizon=30.0)
    assert m.prof.charged > 0
    _, fleet = CASES["fleet_drain"](S, port_autoscale)
    assert len(fleet.drain_log) == 1 and fleet.drain_log[0][2]
    _, fleet = CASES["fleet_autoscale"](S, port_autoscale)
    assert [e for e in fleet.scale_log if e[1] == "scale_up"]


def test_fewer_cores_is_never_faster_on_the_port():
    """The reference's monotonicity property (tests/test_sim.py) on the
    port's DES, at tp 1 as ``chip_smoke.py`` sweeps it: victim TTFT at
    fewer cores is never below the TTFT at more."""
    S = port_sim
    ttfts = []
    for cores in (2, 4, 16):
        res = S.attacker_victim_workload(
            S.llama8b_tp4_params(cores, tp=1), attacker_rps=8,
            attacker_tokens=20_000, n_victims=1, duration=3.0,
            horizon=120.0)
        ttfts.append(res.victim_ttfts()[0])
    assert None not in ttfts
    assert all(a >= b * 0.999 for a, b in zip(ttfts, ttfts[1:]))
