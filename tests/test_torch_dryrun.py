"""The dry-run driver and the roofline (``repro_torch.launch.dryrun``,
``repro_torch.roofline``) against the JAX package's.

* ``param_count``, ``model_flops``, ``model_bytes_per_device`` and
  ``roofline_terms`` equal ``repro.roofline.model``'s for the ten
  architectures and four cells, the reference's ``roofline_terms`` given
  the port's H100 figures as its hardware.
* ``CollectiveCounter`` counts a known all-gather, all-reduce and
  all-to-all, with their operand bytes, on a fake 16-rank mesh.
* ``run_cell`` on ``tiny`` configs (qwen2, granite-moe, falcon-mamba,
  zamba2) and small cells, for train, prefill and decode, on a fake
  (4, 4) and (2, 4, 4) mesh: status ``ok``, collectives counted (none on
  a (1, 1) mesh), and on (4, 4) ``depth_extrapolate`` equal to the
  full-depth trace for the archs with whole periods.
* traced FLOPs a device, times the devices, within a stated factor of
  ``model_flops`` (forward, recomputation and backward) for each traced
  arch and cell on the (4, 4) mesh; on both meshes a train step's
  FLOPs a device within [4, 4.6] times the prefill's at the same shape
  (forward, its recomputation, and a backward of about twice the
  forward), which a layout that runs backward products whole breaks;
* on ``meta`` tensors, B2, B3, B4 and the backward kernels give their
  results' shapes and dtypes (those of the plain versions on the CPU)
  and book their analytic operations and bytes; the CLI writes an ``ok``
  record for qwen2-0.5b ``decode_32k`` at full width, and takes every
  flag of ``repro.launch.dryrun.main``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import ALL_CELLS as J_CELLS
from repro.configs import get_config as jget_config
from repro.roofline import model as JR
from repro_torch.configs import ShapeCell, get_config
from repro_torch.configs.base import MoEConfig, SSMConfig
from repro_torch.kernels import decode_attention as B2
from repro_torch.kernels import flash_attention as B3
from repro_torch.kernels import mamba_scan as B4
from repro_torch.kernels._build import META_SINKS
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_world, make_debug_mesh
from repro_torch.roofline import H100_SXM, CollectiveCounter, collective_bytes
from repro_torch.roofline import model as TR

SRC = Path(__file__).resolve().parent.parent / "src"
ARCHS = ("whisper-small", "falcon-mamba-7b", "granite-20b", "gemma3-12b",
         "olmo-1b", "qwen2-0.5b", "zamba2-1.2b", "granite-moe-3b-a800m",
         "qwen2-moe-a2.7b", "qwen2-vl-7b")
TRACED = ("qwen2-0.5b", "granite-moe-3b-a800m", "falcon-mamba-7b",
          "zamba2-1.2b")
WHOLE_PERIODS = ("qwen2-0.5b", "granite-moe-3b-a800m", "falcon-mamba-7b")
CELLS = {"train": ShapeCell("train_tiny", "train", 32, 16),
         "prefill": ShapeCell("prefill_tiny", "prefill", 32, 16),
         "decode": ShapeCell("decode_tiny", "decode", 32, 16)}


def tiny(name: str):
    """The tests' reduced configs (``conftest.tiny``) for the traced
    families, on the port's configs."""
    cfg = get_config(name)
    over = dict(n_layers=3, d_model=64, d_ff=128 if cfg.d_ff else 0,
                vocab_size=257, vocab_pad_multiple=8, dtype="float32")
    if cfg.n_heads:
        over.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4) or 1,
                    d_head=16)
    if cfg.moe is not None:
        over["moe"] = MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                                n_shared_experts=cfg.moe.n_shared_experts
                                and 2, capacity_factor=4.0)
    if cfg.ssm is not None:
        over["ssm"] = SSMConfig(version=cfg.ssm.version, d_state=8, d_conv=4,
                                expand=2, head_dim=16, dt_rank=8, chunk=16)
    if cfg.hybrid_period is not None:
        over.update(n_layers=5, hybrid_period=3)
    return cfg.scaled(**over)


# ---------------------------------------------------------------------------
# the roofline model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_model_equals_the_reference(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jhw = JR.HardwareSpec(**dataclasses.asdict(H100_SXM))
    for active in (False, True):
        assert TR.param_count(tcfg, active) == JR.param_count(jcfg, active)
    for jc in J_CELLS:
        tc = ShapeCell(jc.name, jc.kind, jc.seq_len, jc.global_batch)
        assert TR.model_flops(tcfg, tc) == JR.model_flops(jcfg, jc)
        for tp, dp, nm in ((16, 16, 1), (16, 32, 2), (8, 4, 4)):
            assert TR.model_bytes_per_device(tcfg, tc, tp=tp, dp=dp,
                                             n_micro=nm) == \
                JR.model_bytes_per_device(jcfg, jc, tp=tp, dp=dp, n_micro=nm)
    for f, b, c in ((1e15, 3e12, 1e9), (1e9, 1e12, 0.0), (0.0, 0.0, 5e11)):
        assert TR.roofline_terms(f, b, c) == JR.roofline_terms(f, b, c, jhw)


def test_the_h100_figures_are_the_datasheet_s():
    assert (H100_SXM.peak_flops, H100_SXM.hbm_bw, H100_SXM.hbm_bytes,
            H100_SXM.link_bw) == (989e12, 3.35e12, 80e9, 450e9)


# ---------------------------------------------------------------------------
# the collectives twin
# ---------------------------------------------------------------------------


def test_collective_counter_counts_known_collectives():
    from repro_torch.dist import sharding as TS
    with fake_world(16):
        mesh = make_debug_mesh((4, 4), ("data", "model"))
        with TS.use_mesh(mesh):
            x = torch.empty(16, 8, device="meta")
            d = TS.place(x, ("data", None))         # local [4, 8] float32
            with CollectiveCounter() as cc:
                d.redistribute(mesh, TS.placements((None, None),
                                                   mesh.mesh_dim_names))
                TS.shard_map(lambda t: TS.psum(t, "model"), mesh,
                             (("data", None),), ("data", None))(d)
                TS.shard_map(lambda t: TS.all_to_all(t, "model", 1, 0),
                             mesh, (("data", None),), ("data", None))(d)
    rec = collective_bytes(cc)
    assert rec["all-gather_count"] == rec["all-reduce_count"] == \
        rec["all-to-all_count"] == 1
    assert rec["all-gather_bytes"] == rec["all-reduce_bytes"] == \
        rec["all-to-all_bytes"] == 4 * 8 * 4
    assert rec["total_count"] == 3 and rec["total_bytes"] == 3 * 128
    assert rec["total_bytes_h100"] == rec["total_bytes"]
    assert sum(cc.get_comm_counts().values()) == 3


# ---------------------------------------------------------------------------
# run_cell on small configs
# ---------------------------------------------------------------------------


MESHES = {"pod_4x4": ((4, 4), ("data", "model")),
          "multipod_2x4x4": ((2, 4, 4), ("pod", "data", "model"))}


def run_records(mesh_name: str, kinds: str, archs: str, out: Path) -> None:
    """The records of one mesh's cells (``kinds`` and ``archs``:
    comma-separated), each to ``out`` as run_cell writes it; ``one`` is a
    (1, 1) mesh."""
    with fake_world(32):
        shape, axes = MESHES.get(mesh_name, ((1, 1), ("data", "model")))
        mesh = make_debug_mesh(shape, axes)
        for arch in archs.split(","):
            for kind in kinds.split(","):
                D.run_cell(arch, CELLS[kind], multi_pod=len(shape) == 3,
                           out_dir=out, verbose=False, config=tiny(arch),
                           mesh=mesh, mesh_name=mesh_name,
                           extrapolate=mesh_name == "pod_4x4")


# five subprocesses at once: the pod's train cells (each run four times:
# the warm-up, depths 1 and 2, full depth) in two halves, its other cells,
# the multi-pod's cells, and the (1, 1) mesh's
ALL_KINDS, ALL_TRACED = ",".join(CELLS), ",".join(TRACED)
RECORD_RUNS = (("pod_4x4", "train", ",".join(TRACED[:2])),
               ("pod_4x4", "train", ",".join(TRACED[2:])),
               ("pod_4x4", "prefill,decode", ALL_TRACED),
               ("multipod_2x4x4", ALL_KINDS, ALL_TRACED),
               ("one", ALL_KINDS, "qwen2-0.5b"))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen([sys.executable, str(Path(__file__)),
                               "records", mesh, kinds, archs, str(out)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for mesh, kinds, archs in RECORD_RUNS]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-4000:]
    recs = {}
    for f in out.glob("*.json"):
        mesh, arch, cell = f.stem.split("__")
        kind = next(k for k, c in CELLS.items() if c.name == cell)
        recs[(mesh, arch, kind)] = json.loads(f.read_text())
    return out, recs


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", TRACED)
@pytest.mark.parametrize("kind", CELLS)
def test_run_cell_on_a_fake_mesh(records, mesh_name, arch, kind):
    out, recs = records
    rec = recs[(mesh_name, arch, kind)]
    assert rec["status"] == "ok"
    assert rec["n_devices"] == int(np.prod(MESHES[mesh_name][0]))
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["collectives"]["total_count"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    terms = rec["roofline"]
    assert terms["dominant_h100"] in ("compute_s", "memory_s",
                                      "collective_s")
    assert terms["bound_s"] > 0 and terms["memory_s_h100_est"] > 0
    on_disk = json.loads((out / f"{mesh_name}__{arch}__"
                                f"{CELLS[kind].name}.json").read_text())
    assert on_disk["status"] == "ok"
    ext = rec["extrapolated"]
    assert (ext is None) == (mesh_name != "pod_4x4")
    if ext is not None and arch in WHOLE_PERIODS:
        # an eager trace counts every period: the two-depth formula gives
        # the full-depth count
        assert ext["flops"] == rec["flops_per_device"]
        assert ext["bytes"] == rec["bytes_per_device"]
        assert ext["coll_bytes_h100"] == \
            rec["collectives"]["total_bytes_h100"]
        assert ext["coll_count"] == rec["collectives"]["total_count"]


@pytest.mark.parametrize("kind", CELLS)
def test_one_rank_mesh_has_no_collectives(records, kind):
    rec = records[1][("one", "qwen2-0.5b", kind)]
    assert rec["status"] == "ok" and rec["n_devices"] == 1
    assert rec["collectives"]["total_count"] == 0


# the factor, either way, within which the traced FLOPs a device, times
# the devices, stay of model_flops on the (4, 4) mesh: the trace counts
# what model_flops leaves out (recomputation in training, kv projections
# replicated over the tensor axis where the kv heads do not split, padded
# heads and vocabulary, norms' and the loss's products); the moe's tiny
# config runs its experts at capacity factor 4, so its factor is 4
FLOPS_FACTOR = {"granite-moe-3b-a800m": 4.0}


@pytest.mark.parametrize("arch", TRACED)
@pytest.mark.parametrize("kind", CELLS)
def test_traced_flops_stay_near_the_model_s(records, arch, kind):
    from repro_torch.roofline import model_flops
    rec = records[1][("pod_4x4", arch, kind)]
    ratio = rec["flops_per_device"] * rec["n_devices"] / model_flops(
        tiny(arch), CELLS[kind])
    f = FLOPS_FACTOR.get(arch, 2.0)
    assert 1 / f <= ratio <= f, ratio


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", TRACED)
def test_train_step_is_about_four_forwards(records, mesh_name, arch):
    recs = records[1]
    ratio = (recs[(mesh_name, arch, "train")]["flops_per_device"]
             / recs[(mesh_name, arch, "prefill")]["flops_per_device"])
    assert 4.0 <= ratio <= 4.6, ratio


# ---------------------------------------------------------------------------
# the kernels on meta tensors, and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,causal,window", [
    (8, True, None), (8, False, None), (8, True, 3), (8, False, 3),
    (5, True, 8), (1, True, 1)])
def test_kept_pairs_counts_the_mask(S, causal, window):
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    keep = np.ones((S, S), bool)
    if causal:
        keep &= i >= j
    if window is not None:
        keep &= j > i - window
    assert B3.kept_pairs(S, causal, window) == keep.sum()


def _inputs_of(which, device):
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(device)
    B, H, KV, S, D, T, Di, N = 2, 4, 2, 8, 16, 6, 5, 3
    if which in ("flash", "flash_bwd"):
        q, k, v = r(B, H, S, D), r(B, KV, S, D), r(B, KV, S, D)
        if which == "flash":
            return (q, k, v), dict(causal=True, window=3, with_lse=True)
        o, lse = B3.flash_attention_bhsd(q, k, v, window=3, with_lse=True)
        return (q, k, v, o, lse, r(B, H, S, D)), dict(causal=True, window=3)
    if which == "decode":
        pos = torch.arange(S, dtype=torch.int32).expand(B, S).to(device)
        clen = torch.full((B,), S - 1, dtype=torch.int32).to(device)
        return ((r(B, H, D), r(B, KV, S, D), r(B, KV, S, D), clen, pos),
                dict(window=4, with_lse=True))
    x, dt = r(B, T, Di), 0.1 * r(B, T, Di).abs()
    scan = (x, dt, r(B, T, N), r(B, T, N), -r(Di, N).abs(), r(B, Di, N))
    if which == "scan":
        return scan, dict(with_checkpoints=True)
    return scan + (r(B, T, Di), r(B, Di, N)), {}


# wrapper, its operations from the shapes above (B 2, H 4, KV 2, S 8,
# D 16, window 3: 21 kept pairs; T 6, Di 5, N 3), its bytes
META_CASES = {
    "flash": (B3.flash_attention_bhsd, 4 * 16 * 4 * 2 * 21,
              4 * 2 * 2 * 8 * 6 * 16 + 4 * 2 * 4 * 8),
    "flash_bwd": (B3.flash_attention_bwd, 10 * 16 * 4 * 2 * 21,
                  4 * 4 * 2 * 8 * 6 * 16 + 4 * 2 * 4 * 8),
    "decode": (B2.decode_attention_bhd, 4 * 16 * 4 * 2 * 8,
               4 * 2 * 2 * (4 + 8 * 2) * 16 + 4 * 2 * 9 + 4 * 2 * 4),
    "scan": (B4.mamba1_scan, 7 * 2 * 6 * 5 * 3 + 2 * 6 * 5,
             4 * (3 * 60 + 2 * 36 + 15 + (2 + 1) * 30)),
    "scan_bwd": (B4.mamba1_scan_bwd, 20 * 2 * 6 * 5 * 3,
                 4 * (5 * 60 + 4 * 36 + 2 * 15 + (1 + 1 + 1 + 1) * 30)),
}


@pytest.mark.parametrize("which", META_CASES)
def test_kernels_on_meta_give_shapes_and_book_their_cost(which):
    fn, flops, nbytes = META_CASES[which]
    args, kw = _inputs_of(which, "cpu")
    want = fn(*args, **kw)
    booked = []
    META_SINKS.append(lambda f, b: booked.append((f, b)))
    try:
        margs = tuple(a.to("meta") for a in args)
        got = fn(*margs, **kw)
    finally:
        META_SINKS.pop()
    assert booked == [(flops, nbytes)]
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got)


def test_cli_writes_an_ok_record(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--cell", "decode_32k", "--out", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "qwen2-0.5b x decode_32k: OK" in proc.stdout
    rec = json.loads((tmp_path / "pod_16x16__qwen2-0.5b__decode_32k.json"
                      ).read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["collectives"]["total_count"] > 0
    assert rec["extrapolated"]["flops"] == rec["flops_per_device"]


def test_cli_takes_every_flag_of_the_reference(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(D, "run_cell", lambda arch, cell, **kw: calls.append(
        (arch, cell, kw["multi_pod"], kw["unroll"])) or {"status": "ok"})
    D.main(["--all", "--both-meshes", "--unroll", "--out", str(tmp_path)])
    assert len(calls) == 2 * 10 * 4
    assert {c[2] for c in calls} == {False, True}
    assert all(c[3] for c in calls)
    calls.clear()
    D.main(["--arch", "olmo-1b", "--multi-pod", "--out", str(tmp_path)])
    assert [c[1] for c in calls] == [c.name for c in J_CELLS]
    assert all(c[0] == "olmo-1b" and c[2] for c in calls)
    with pytest.raises(SystemExit):
        D.main([])


if __name__ == "__main__":
    run_records(sys.argv[2], sys.argv[3], sys.argv[4], Path(sys.argv[5]))
