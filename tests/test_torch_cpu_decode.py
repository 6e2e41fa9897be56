"""The port's ``cpu`` leaf against ``repro``'s.

``repro_torch.backend.cpu_decode.CpuDecodeBackend`` is the paged surrogate
with a plain float32 attention on the CPU.  Its ``_attend`` must give the
logits of ``repro.backend.cpu_decode.CpuDecodeBackend._attend`` on the
same pools (fp32 and int8, 1e-5), and the two leaves, each driven by its
own package's scheduler in lockstep, must broadcast the same plan bytes
and sample the same tokens at every step, on tests/test_torch_backend.py's
workloads (prefix cache, k-step macro-plans, swap churn with and without
the copy engine, int8 pools).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.backend.cpu_decode import CpuDecodeBackend as RefCpuDecode
from repro_torch.backend import make_backend
from repro_torch.backend.cpu_decode import CpuDecodeBackend
from repro_torch.serving.scheduler import SchedulerConfig, StepPlan
from test_torch_backend import CASES, VOCAB, drive_lockstep


def _leaves(cfg, kv_dtype="float32"):
    kw = dict(block_size=cfg.block_size, num_blocks=cfg.num_kv_blocks,
              num_swap_blocks=cfg.num_swap_blocks,
              copy_streams=cfg.copy_streams, vocab=VOCAB, kv_dtype=kv_dtype)
    return RefCpuDecode(**kw), CpuDecodeBackend(**kw)


@pytest.mark.parametrize("kv_dtype", ("float32", "int8"))
def test_attend_matches_the_reference_leaf(kv_dtype):
    """The same pools (the reference's codes and scales copied in) and the
    same queries, tables and lengths give the same logits, 1e-5."""
    cfg = SchedulerConfig(**CASES["k1"][0])
    ref, port = _leaves(cfg, kv_dtype)
    toks = [3 + (i * 7) % 90 for i in range(29)]
    ref.execute(StepPlan(1, [(1, 0, 29)], [], [],
                         block_tables={1: [5, 2, 9, 11]},
                         new_tokens={1: toks}))
    n = cfg.num_kv_blocks
    port.k_pages[:, :n] = torch.from_numpy(ref.k_pages)
    port.v_pages[:, :n] = torch.from_numpy(ref.v_pages)
    if kv_dtype == "int8":
        port.k_scales[:, :n] = torch.from_numpy(ref.k_scales)
        port.v_scales[:, :n] = torch.from_numpy(ref.v_scales)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((4, 4, 16)).astype(np.float32)
    bt = np.array([[5, 2, 9, 11], [5, 2, -1, -1], [9, -1, 2, -1],
                   [11, -1, -1, -1]], np.int32)
    sl = np.array([29, 13, 20, 0], np.int32)     # a -1 inside, an empty row
    want = ref._attend(q, bt, sl)
    got = port._attend(torch.from_numpy(q), torch.from_numpy(bt),
                       torch.from_numpy(sl))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lockstep_streams_identical_to_the_reference_leaf(case):
    cfg_kw, specs, kv_dtype = CASES[case]
    jreqs, treqs, tsched, tbe, _ = drive_lockstep(
        cfg_kw, specs, lambda cfg: _leaves(cfg, kv_dtype))
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert tsched.blocks.free_blocks == tsched.blocks.num_blocks
    assert not tbe._seq_lens


def test_cpu_leaf_never_runs_on_the_card():
    cfg = SchedulerConfig(**CASES["k1"][0])
    with pytest.raises(ValueError, match="runs on the CPU"):
        CpuDecodeBackend(block_size=8, num_blocks=4, device="cuda")
    # the factory's torch_device applies to torch leaves only
    be = make_backend("cpu", scheduler_cfg=cfg, torch_device="cuda")
    assert be.k_pages.device == torch.device("cpu")
    assert be.num_blocks == cfg.num_kv_blocks
