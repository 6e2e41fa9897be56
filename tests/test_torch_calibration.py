"""The port's calibration (``repro_torch.launch.dryrun.emit_devmodel``).

On the CPU, at a tiny config and two small cells: it writes the
reference's record (``arch``, ``prefill_cell``, ``decode_cell``,
``device_model`` with ``repro.core.devmodel.DeviceModel``'s fields) plus
``measured_on``, its coefficients are what the reference's
``DeviceModel.from_roofline`` makes of the measured seconds, and
``repro_torch.launch.serve --backend emulated --devmodel`` consumes the
file.  A batch that runs out of device memory is halved and the cut
recorded; without a card the default device raises.  (The CLI's
compile-driver flags are ``tests/test_torch_dryrun.py``'s.)
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core.devmodel import DeviceModel as RefDeviceModel
from repro_torch.configs import ShapeCell, get_config
from repro_torch.launch.train import tiny_config
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
PREFILL = ShapeCell("tiny_prefill", "prefill", 32, 2)
DECODE = ShapeCell("tiny_decode", "decode", 48, 3)


def _emit(arch, out_dir):
    return dryrun.emit_devmodel(arch, out_dir, PREFILL, DECODE, device="cpu",
                                config=tiny_config(get_config(arch)))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "falcon-mamba-7b",
                                  "zamba2-1.2b", "whisper-small",
                                  "qwen2-vl-7b"])
def test_emit_devmodel_writes_the_reference_record(arch, tmp_path):
    rec = _emit(arch, tmp_path)
    assert json.loads((tmp_path / f"devmodel__{arch}.json").read_text()) \
        == rec
    assert set(rec) == {"arch", "prefill_cell", "decode_cell",
                        "device_model", "measured_on"}
    assert (rec["arch"], rec["prefill_cell"], rec["decode_cell"]) == \
        (arch, "tiny_prefill", "tiny_decode")
    dm = rec["device_model"]
    assert set(dm) == set(dataclasses.asdict(RefDeviceModel()))
    assert dm["t_prefill_tok"] > 0 and dm["t_decode_seq"] > 0 \
        and dm["t_fixed"] > 0
    on = rec["measured_on"]
    assert on["device"].startswith("cpu") and on["cuts"] == []
    assert (on["prefill"]["batch"], on["prefill"]["seq_len"]) == (2, 32)
    assert (on["decode"]["batch"], on["decode"]["cache_len"]) == (3, 47)
    assert len(on["prefill"]["runs"]) == dryrun.REPEATS
    # the reference's own arithmetic on the measured seconds
    want = RefDeviceModel.from_roofline(on["prefill"]["seconds"], 2 * 32,
                                        on["decode"]["seconds"], 3)
    assert dm == dataclasses.asdict(want)


def test_a_batch_out_of_memory_is_halved_and_recorded():
    calls = []

    def run(b):
        calls.append(b)
        if b > 4:
            raise torch.OutOfMemoryError("CUDA out of memory")
        return f"ran {b}"

    cuts = []
    assert dryrun._fitting(run, 32, "prefill", cuts) == (4, "ran 4")
    assert calls == [32, 16, 8, 4]
    assert cuts == [f"prefill batch {b} -> {b // 2}: out of device memory"
                    for b in (32, 16, 8)]
    with pytest.raises(torch.OutOfMemoryError):
        dryrun._fitting(lambda b: run(99), 2, "decode", [])


def test_serve_runs_on_the_emitted_devmodel(tmp_path):
    _emit("qwen2-0.5b", tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--backend",
         "emulated", "--devmodel", str(tmp_path / "devmodel__qwen2-0.5b.json"),
         "--tp", "2", "--cores", "2", "--requests", "4", "--rps", "50",
         "--words", "30", "--max-new", "3"],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[serve] completed 4/4" in proc.stdout


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.emit_devmodel("qwen2-0.5b", tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--emit-devmodel", "--arch", "qwen2-0.5b", "--out",
                     str(tmp_path)])
    assert not list(tmp_path.iterdir())
