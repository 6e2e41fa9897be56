"""The serving leaf's trace-only spans (``profiling.LEAF_SITES``).

A traced live engine on the CPU records, inside every worker ``device``
span, the leaf's ``leaf_pack``, ``leaf_copy``, ``leaf_launch`` and
``leaf_read`` spans of the same step, one after another; an untraced run
of the same requests records nothing and serves the same tokens.  The
operator summaries give the leaf's spans no row of their own, and no
leaf name is an injection site.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict

import pytest

from repro_torch import profiling
from repro_torch.backend.torch_backend import TorchBackend
from repro_torch.core.devmodel import DeviceModel
from repro_torch.core.engine import EngineConfig, ServingSystem
from repro_torch.profiling import (LEAF_SITES, SITES, Profiler,
                                   ProfilingConfig, SpanEvent,
                                   critical_path_summary, parse_inject,
                                   phase_summary)
from repro_torch.serving.scheduler import SchedulerConfig, StepPlan

# a rounding margin for sums of perf_counter readings, far below the time
# between two statements
CLOCK_EPS = 1e-9


class _Tape:
    """A worker's backend, its results appended to a file a plan (the
    engine's records count tokens, not their values)."""

    def __init__(self, inner, out_dir):
        self.inner = inner
        self.path = os.path.join(out_dir, f"tape-{os.getpid()}.jsonl")

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def execute(self, plan, block_tables=None):
        res = self.inner.execute(plan, block_tables)
        steps = None if res.token_steps is None else [
            {str(r): t for r, t in row.items()} for row in res.token_steps]
        with open(self.path, "a") as f:
            f.write(json.dumps({
                "prefill": [rid for rid, _, _ in plan.prefill],
                "decode": list(plan.decode),
                "tokens": {str(r): t for r, t in res.tokens.items()},
                "steps": steps}) + "\n")
        return res


def _streams(path):
    """Each request's sampled tokens in order, from one worker's tape."""
    out = defaultdict(list)
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            toks = rec["tokens"]
            for rid in rec["prefill"]:
                if str(rid) in toks:
                    out[rid].append(toks[str(rid)])
            for rid in rec["decode"]:
                if rec["steps"] is None:
                    out[rid].append(toks[str(rid)])
                else:
                    out[rid] += [row[str(rid)] for row in rec["steps"]
                                 if str(rid) in row]
    return dict(out)


def _serve(monkeypatch, tmp_path, multi_step, trace):
    """Six requests through a two-worker torch engine on the CPU, each
    sent once the one before it is answered; the workers' stats and each
    worker's token streams.  The live engine feeds a decode step the
    placeholder token 0, and a k-step plan feeds back what it sampled, so
    a request's tokens depend on how its steps were grouped: requests one
    at a time give both runs the same plans."""
    import repro_torch.backend as backend_mod
    out_dir = tmp_path / ("traced" if trace else "untraced")
    out_dir.mkdir()
    original = backend_mod.make_backend
    monkeypatch.setattr(backend_mod, "make_backend",
                        lambda *a, **k: _Tape(original(*a, **k),
                                              str(out_dir)))
    cfg = EngineConfig(
        tp_degree=2, pool_width=2, backend="torch", torch_device="cpu",
        device=DeviceModel(t_fixed=1e-4, t_prefill_tok=1e-7,
                           t_decode_seq=1e-5),
        scheduler=SchedulerConfig(kv_capacity_tokens=4096, block_size=16,
                                  max_steps_per_dispatch=multi_step),
        yield_every=64, profiling=ProfilingConfig(trace=trace))
    sys_ = ServingSystem(cfg).start()
    try:
        n = 6
        for i in range(n):
            sys_.submit(f"the quick brown fox number {i} " * 4,
                        max_new_tokens=6)
            results = sys_.collect(i + 1, timeout=90.0)
            assert len(results) == i + 1, f"request {i} was not answered"
    finally:
        stats = sys_.shutdown()
    workers = {s["role"]: s for s in stats
               if s["role"].startswith("worker")}
    assert sorted(workers) == ["worker0", "worker1"]
    streams = [_streams(p) for p in sorted(out_dir.glob("tape-*.jsonl"))]
    assert len(streams) == 2
    return workers, streams


@pytest.mark.parametrize("multi_step", [1, 4])
def test_leaf_spans_nest_in_device_and_tracing_changes_no_token(
        monkeypatch, tmp_path, multi_step):
    for var in (profiling.ENV_TRACE, profiling.ENV_INJECT):
        monkeypatch.delenv(var, raising=False)
    traced, traced_streams = _serve(monkeypatch, tmp_path, multi_step, True)
    for role, stats in traced.items():
        events = stats["trace_events"]
        devices = [ev for ev in events if ev.site == "device"]
        leaves = defaultdict(list)
        for ev in events:
            if ev.site in LEAF_SITES:
                leaves[ev.step].append(ev)
        assert devices, role
        # every leaf span belongs to a device span of its step
        assert set(leaves) == {d.step for d in devices}, role
        prefill_plans = 0
        for d in devices:
            kids = sorted(leaves[d.step], key=lambda ev: ev.t0)
            assert {ev.site for ev in kids} == set(LEAF_SITES), (role, d)
            for ev in kids:
                assert ev.phase == d.phase
                assert d.t0 <= ev.t0
                assert ev.t0 + ev.dur <= d.t0 + d.dur + CLOCK_EPS
            for a, b in zip(kids, kids[1:]):
                assert a.t0 + a.dur <= b.t0 + CLOCK_EPS, (role, a, b)
            if d.phase == "prefill":
                # _prefill_rows' token list and _write's pack, copy and
                # launch come before the sampled tokens' copy, launch and
                # read
                prefill_plans += 1
                first_read = next(i for i, ev in enumerate(kids)
                                  if ev.site == "leaf_read")
                before = [ev.site for ev in kids[:first_read]]
                assert before.count("leaf_pack") >= 3, before
                assert before.count("leaf_copy") >= 2, before
                assert before.count("leaf_launch") >= 2, before
        assert prefill_plans, role

    untraced, untraced_streams = _serve(monkeypatch, tmp_path, multi_step,
                                        False)
    for role, stats in untraced.items():
        assert stats["trace_events"] == [], role
    # both workers sample the same tokens, traced or not
    assert traced_streams[0] == traced_streams[1]
    assert untraced_streams[0] == untraced_streams[1]
    assert traced_streams[0] == untraced_streams[0]
    assert all(len(s) == 6 for s in traced_streams[0].values())


def _backend():
    return TorchBackend(block_size=4, num_blocks=16, device="cpu",
                        max_steps=4)


def test_untraced_leaf_spans_are_one_shared_no_op():
    """No profiler, or one that only injects: ``execute`` leaves the
    leaf's trace state unset and every span is the same no-op context."""
    be = _backend()
    plan = StepPlan(0, [(1, 0, 3)], [], [], block_tables={1: [0]},
                    new_tokens={1: [5, 6, 7]})
    prev = profiling.install(Profiler(ProfilingConfig(inject="scheduler=0")))
    try:
        be.execute(plan)
        assert profiling.active().events == []
    finally:
        profiling.install(prev)
    assert be._trace is None
    assert be._span("leaf_pack") is be._span("leaf_read")


def test_traced_execute_records_its_step_and_resets():
    """A traced ``execute`` of a prefill plan, a k-step plan and a k-step
    plan with a prefill row records the leaf's spans with the plan's step
    and phase, and leaves no trace state behind, also when it raises."""
    be = _backend()
    prof = Profiler(ProfilingConfig(trace=True), role="worker0")
    prev = profiling.install(prof)
    try:
        be.execute(StepPlan(3, [(1, 0, 3)], [], [], block_tables={1: [0]},
                            new_tokens={1: [5, 6, 7]}))
        be.execute(StepPlan(4, [], [1], [], block_tables={1: [0, 1]},
                            new_tokens={1: [9]}, num_steps=4,
                            decode_steps={1: 4}))
        be.execute(StepPlan(5, [(2, 0, 3)], [1], [],
                            block_tables={1: [0, 1, 3], 2: [2]},
                            new_tokens={1: [4], 2: [1, 2, 3]}, num_steps=4,
                            decode_steps={1: 4}))
        with pytest.raises(IndexError):
            # a prefill chunk past its table
            be.execute(StepPlan(6, [(3, 0, 9)], [], [],
                                block_tables={3: [4]},
                                new_tokens={3: list(range(9))}))
    finally:
        profiling.install(prev)
    assert be._trace is None
    by_step = defaultdict(list)
    for ev in prof.events:
        by_step[ev.step].append((ev.site, ev.phase))
    write = ["leaf_pack", "leaf_copy", "leaf_launch"]
    sample = list(LEAF_SITES)
    # _prefill_rows' token list, its _write, the decode rows' _write
    # (none: its pack finds no token), then _sample_rows
    assert by_step[3] == [(s, "prefill") for s in
                          ["leaf_pack"] + write + ["leaf_pack"] + sample]
    assert by_step[4] == [(s, "decode") for s in sample]
    # the prefill row sampled, then the k-step loop
    assert by_step[5] == [(s, "mixed") for s in
                          ["leaf_pack"] + write + sample + sample]
    assert [s for s, _ in by_step[6]] == ["leaf_pack", "leaf_pack"]


def _pairs(with_leaf):
    """An engine step and two workers' device spans, with or without the
    leaf's spans inside them."""
    ev = [("engine", SpanEvent("scheduler", 0.0, 1.0, step=7)),
          ("engine", SpanEvent("shm_publish", 1.0, 0.5, step=7)),
          ("engine", SpanEvent("barrier", 1.5, 4.0, step=7))]
    for w, t in (("worker0", 1.6), ("worker1", 1.8)):
        ev.append((w, SpanEvent("dispatch", t, 0.2, step=7,
                                phase="decode")))
        ev.append((w, SpanEvent("device", t + 0.2, 3.0, step=7,
                                phase="decode")))
        if with_leaf:
            for i, site in enumerate(LEAF_SITES):
                ev.append((w, SpanEvent(site, t + 0.3 + 0.6 * i, 0.5,
                                        step=7, phase="decode")))
    ev.append(("engine", SpanEvent("block_alloc", 0.5, 0.0, step=7,
                                   instant=True)))
    return sorted(ev, key=lambda p: p[1].t0)


def test_summaries_count_leaf_spans_as_device_cover():
    for summary in (critical_path_summary, phase_summary):
        bare, traced = summary(_pairs(False)), summary(_pairs(True))
        assert traced == bare
    assert not set(critical_path_summary(_pairs(True))) & set(LEAF_SITES)
    assert set(critical_path_summary(_pairs(True))) == {
        "scheduler", "shm_publish", "barrier", "dispatch", "block_alloc"}


@pytest.mark.parametrize("site", LEAF_SITES)
def test_leaf_sites_are_not_injection_sites(site):
    assert site not in SITES
    assert not set(parse_inject("*=5")) & set(LEAF_SITES)
    with pytest.raises(ValueError, match="unknown injection site"):
        parse_inject(f"{site}=5")
