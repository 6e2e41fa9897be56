"""The examples' twins in ``repro_torch.launch``.

``serve_contention`` runs the attacker/victim experiment on the live
engine: on the emulated backend (the reference example's run) and on the
torch backend on the CPU at the toy widths, both runs completing without a
victim timeout; on the default device it raises without a card.
``core_sweep_sim`` prints what ``examples/core_sweep_sim.py`` prints for
the same arguments, line for line.
"""
from __future__ import annotations

import os
import re
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import core_sweep_sim

ROOT = Path(__file__).resolve().parents[1]


def _contention(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_contention", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)


@pytest.mark.parametrize("args", [["--backend", "emulated"],
                                  ["--backend", "torch", "--device", "cpu"]])
def test_serve_contention_completes_both_runs(args):
    proc = _contention(*args)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    for label in ("no-load", "attacker-load"):
        assert re.search(rf"\[{label}\] victim TTFT=[\d.]+ms "
                         rf"tokenize=[\d.]+ms dequeue_p95=[\d.]+ms", out)
        for w in (0, 1):
            assert re.search(rf"\[{label}\] worker{w} startup=[\d.]+s "
                             rf"kernel_launches=0", out)
    assert "victim TTFT degradation under attacker load:" in out


def test_serve_contention_raises_without_a_card():
    """The torch backend targets the card unless asked: on a machine
    without one (and here without nvcc) it fails rather than running on
    the CPU."""
    proc = _contention("--backend", "torch")
    assert proc.returncode != 0
    assert re.search(r"nvcc not found|no CUDA device", proc.stderr)
    assert "victim TTFT" not in proc.stdout


@pytest.mark.parametrize("argv", [
    ["--tp", "2", "--rps", "1", "--attack-tokens", "20000"],
    ["--tp", "1", "--rps", "1", "--attack-tokens", "20000"]])
def test_core_sweep_sim_prints_the_reference_lines(argv, capsys,
                                                   monkeypatch):
    core_sweep_sim.main(argv)
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["core_sweep_sim.py", *argv])
    runpy.run_path(str(ROOT / "examples" / "core_sweep_sim.py"),
                   run_name="__main__")
    ref = capsys.readouterr().out
    assert port.count("cores=") == 5 and "advice:" in port
    assert port == ref
