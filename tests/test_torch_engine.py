"""The port's live serving engine: forked EngineCore and workers.

A ``repro_torch`` ``ServingSystem`` with two workers answers short
requests end to end on the CPU, through the copied control plane
(tokenizer pool, scheduler, /dev/shm broadcast ring, completion board)
and the torch backend, whose workers build their backends after the
fork with one intra-op thread.  On the CPU the kernel wrapper computes
its plain version, so the workers report 0 kernel launches.  The serve
CLI is driven once as a subprocess.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.core.devmodel import DeviceModel
from repro_torch.core.engine import EngineConfig, ServingSystem
from repro_torch.serving.scheduler import SchedulerConfig

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("backend,kv_dtype,multi_step", [
    ("torch", "float32", 1), ("torch", "float32", 4), ("torch", "int8", 1),
    ("emulated", "float32", 1)])
def test_live_engine_answers_every_request(backend, kv_dtype, multi_step):
    cfg = EngineConfig(
        tp_degree=2, pool_width=2, backend=backend, torch_device="cpu",
        kv_dtype=kv_dtype,
        device=DeviceModel(t_fixed=1e-4, t_prefill_tok=1e-7,
                           t_decode_seq=1e-5),
        scheduler=SchedulerConfig(kv_capacity_tokens=4096, block_size=16,
                                  max_steps_per_dispatch=multi_step),
        yield_every=64)
    sys_ = ServingSystem(cfg).start()
    try:
        n = 6
        for i in range(n):
            sys_.submit(f"the quick brown fox number {i} " * 4,
                        max_new_tokens=5)
        results = sys_.collect(n, timeout=90.0)
        assert len(results) == n, f"only {len(results)}/{n} completed"
        for rec in results.values():
            assert not rec["timed_out"]
            assert rec["n_generated"] == 5
            assert rec["t_first_token"] > rec["t_arrival"]
    finally:
        stats = sys_.shutdown()
    workers = [s for s in stats if s["role"].startswith("worker")]
    assert sorted(s["role"] for s in workers) == ["worker0", "worker1"]
    for s in workers:
        assert s["dequeue_wall"], "every worker executed plans"
        assert s["execute_wall"] and s["startup_s"] > 0
        assert s["kernel_launches"] == 0       # CPU: the plain version


def _serve(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)


def test_serve_cli_on_cpu():
    proc = _serve("--backend", "torch", "--device", "cpu", "--tp", "2",
                  "--cores", "2", "--requests", "4", "--rps", "50",
                  "--words", "30", "--max-new", "3", "--multi-step", "2")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[serve] completed 4/4" in proc.stdout
    assert "[serve] workers=2 kernel_launches=0" in proc.stdout


@pytest.mark.parametrize("flag", (
    ["--backend", "hybrid", "--prefill-backend", "torch",
     "--decode-backend", "emulated"],
    ["--backend", "hybrid", "--prefill-backend", "emulated",
     "--decode-backend", "cpu"],
    ["--backend", "torch", "--speculative-k", "2", "--draft-backend",
     "emulated"]))
def test_serve_refuses_what_is_not_ported(flag):
    """Every composition is ported; what serve still refuses, before any
    process forks, is a pairing that mixes a physical and an emulated
    child (a hybrid's tiers, or a speculative target and its draft)."""
    proc = _serve(*flag)
    assert proc.returncode == 2
    assert "physical" in proc.stderr


def test_worker_sees_every_leaf_and_counts_every_child(monkeypatch):
    """``EngineConfig.leaves`` names what a worker builds (its thread
    guard and the owner's nvcc build read it), and the worker's stats read
    B1's per-process launch count and the composites' counters through a
    speculative wrapper around a hybrid."""
    from repro_torch.backend import make_backend
    from repro_torch.core.engine import _composite_counters, _kernel_launches
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    spec = SchedulerConfig(kv_capacity_tokens=512, block_size=8,
                           speculative_k=2)
    assert EngineConfig(backend="torch").leaves() == {"torch"}
    assert EngineConfig(backend="hybrid", prefill_backend="torch",
                        decode_backend="cpu").leaves() == {"torch", "cpu"}
    assert EngineConfig(backend="torch", scheduler=spec).leaves() == {
        "torch", "cpu"}
    assert EngineConfig(backend="emulated", scheduler=spec).leaves() == {
        "emulated"}
    be = make_backend("hybrid", scheduler_cfg=spec, prefill_backend="torch",
                      decode_backend="cpu", torch_device="cpu")
    monkeypatch.setattr(paged_decode_attention, "launches", 7)
    assert _kernel_launches(be) == 7
    assert _composite_counters(be) == {
        "n_spec_steps": 0, "n_drafted": 0, "n_accepted": 0,
        "n_handoffs": 0, "n_handoff_blocks": 0}
    assert _kernel_launches(make_backend("emulated")) == 0
