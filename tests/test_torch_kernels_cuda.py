"""The CUDA kernel of paged decode attention against its plain version.

These tests need the card (marker ``cuda``) and skip without one.  They
import neither JAX nor ``repro``, so that they run where only the port is
installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Besides ``make_case``'s rows at every GQA group and head dim and pages of
8 and 16 slots, the split over pages:
split counts from 1 to one page per split (through the private
``_launch(n_splits=...)``; the public wrapper always takes
``choose_splits``), the serving shapes at 8 and 64 rows, pages of other
lengths than the 64-slot tile, and bitwise-equal repeated calls.
``make_case`` also feeds tests/test_torch_paged_attention.py, which holds
the plain version against the JAX package on the CPU.

Then the call shape of speculative verify (``verify_rows``: k+1 rows per
request on one block table, seq_lens start+1 .. start+k+1), held to the
plain version and to the split rule, and speculative decode on the card
against stepwise greedy decode on the card, token for token, at the
toy width and at the serve runs'; at the toy width the card's stepwise
streams also equal the CPU's, for ``TorchBackend`` (its k-step plans
replayed from captured graphs) and for the hybrid with an fp32 or int8
decode tier.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_decode_attention import _launch as launch_paged
from repro_torch.kernels.paged_decode_attention import (
    ROW_GROUP,
    _blocks_per_sm,
    choose_splits,
    paged_decode_attention,
    paged_decode_attention_reference,
    paged_decode_attention_split_reference,
    split_ranges,
)

TOL = dict(atol=1e-5, rtol=1e-5)
KV = 2


def make_case(seed: int, *, r: int, D: int, block: int, quantized: bool):
    """Seeded inputs as numpy arrays.  Rows: ragged lengths, a -1 page in
    the middle of a valid range, a seq_len-0 row on real pages, a
    seq_len-0 row of -1 entries, and a row whose only pages are -1."""
    rng = np.random.default_rng(seed)
    H, N, nb = r * KV, 24, 5
    lens = [3 * block + 5, block, 0, 2 * block + 1, 0, block + 3, 4]
    B = len(lens)
    perm = rng.permutation(N)
    bt = np.full((B, nb), -1, np.int32)
    used = 0
    for b, n_tok in enumerate(lens):
        n_pages = -(-n_tok // block)
        bt[b, :n_pages] = perm[used:used + n_pages]
        used += n_pages
    bt[0, 1] = -1                       # masked page inside the valid range
    bt[2, :2] = perm[used:used + 2]     # seq_len 0 on real pages
    bt[6, :] = -1                       # seq_len 4 but only -1 entries
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    case = dict(q=q, block_tables=bt, seq_lens=np.asarray(lens, np.int32))
    if quantized:
        shape = (KV, N, block, D)
        case["k_pages"] = rng.integers(-127, 128, shape).astype(np.int8)
        case["v_pages"] = rng.integers(-127, 128, shape).astype(np.int8)
        case["k_scales"] = rng.uniform(0.1, 3.0, (KV, N)).astype(np.float32)
        case["v_scales"] = rng.uniform(0.1, 3.0, (KV, N)).astype(np.float32)
    else:
        for name in ("k_pages", "v_pages"):
            case[name] = rng.standard_normal(
                (KV, N, block, D)).astype(np.float32)
    return case


def _torch(case):
    args = [torch.from_numpy(case[k]) for k in
            ("q", "k_pages", "v_pages", "block_tables", "seq_lens")]
    kw = {k: torch.from_numpy(case[k]) for k in ("k_scales", "v_scales")
          if k in case}
    return args, kw


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", (False, True), ids=("fp32", "int8"))
@pytest.mark.parametrize("r", (1, 2, 7, 16))
@pytest.mark.parametrize("D", (16, 32, 64, 128))
@pytest.mark.parametrize("block", (8, 16))
def test_kernel_matches_plain_version_on_card(cuda_device, block, quantized,
                                              r, D):
    case = make_case(r + D, r=r, D=D, block=block, quantized=quantized)
    args, kw = _torch(case)
    args = [a.to(cuda_device) for a in args]
    kw = {k: v.to(cuda_device) for k, v in kw.items()}
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args, **kw)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    torch.testing.assert_close(
        got, paged_decode_attention_reference(*args, **kw), **TOL)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    case = make_case(2, r=2, D=16, block=8, quantized=False)
    args, _ = _torch(case)
    args = [a.to(cuda_device) for a in args]
    with pytest.raises(ValueError):          # head dim 24 is not built
        paged_decode_attention(torch.zeros(7, 4, 24, device=cuda_device),
                               *args[1:])
    with pytest.raises(TypeError):           # int64 tables
        paged_decode_attention(args[0], args[1], args[2], args[3].long(),
                               args[4])


# -- the split over pages ----------------------------------------------------

def _on(case, device):
    args, kw = _torch(case)
    return ([a.to(device) for a in args],
            {k: v.to(device) for k, v in kw.items()})


def serving_rows(rows: int, *, quantized: bool, block: int = 64,
                 nb: int = 32, seed: int = 0):
    """qwen2-0.5b's heads (H 14, KV 2, D 64) over a pool of rows * nb
    pages: ragged lengths, a seq_len-0 row, a -1 entry inside a range, and
    a long table whose valid pages all lie in its first split."""
    rng = np.random.default_rng(seed)
    N = rows * nb
    bt = rng.permutation(N).astype(np.int32).reshape(rows, nb)
    lens = rng.integers(1, nb * block + 1, rows).astype(np.int32)
    lens[0] = 2 * block - 3                   # two pages of 32: one split
    lens[1] = 0
    for b in range(rows):
        bt[b, -(-int(lens[b]) // block):] = -1
    bt[2, 1] = -1
    case = dict(q=rng.standard_normal((rows, 14, 64)).astype(np.float32),
                block_tables=bt, seq_lens=lens)
    shape = (KV, N, block, 64)
    if quantized:
        case["k_pages"] = rng.integers(-127, 128, shape).astype(np.int8)
        case["v_pages"] = rng.integers(-127, 128, shape).astype(np.int8)
        case["k_scales"] = rng.uniform(0.1, 3.0, (KV, N)).astype(np.float32)
        case["v_scales"] = rng.uniform(0.1, 3.0, (KV, N)).astype(np.float32)
    else:
        case["k_pages"] = rng.standard_normal(shape).astype(np.float32)
        case["v_pages"] = rng.standard_normal(shape).astype(np.float32)
    return case


def _split_check(case, device, n_splits):
    args, kw = _on(case, device)
    before = paged_decode_attention.launches
    got = launch_paged(*args, **kw, n_splits=n_splits)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    torch.testing.assert_close(
        got, paged_decode_attention_reference(*args, **kw), **TOL)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n_splits", (1, 2, 3, 5))
@pytest.mark.parametrize("quantized", (False, True), ids=("fp32", "int8"))
@pytest.mark.parametrize("r", (1, 7, 16))
@pytest.mark.parametrize("D", (16, 64, 128))
def test_kernel_split_counts_match_plain_version(cuda_device, quantized, r,
                                                 D, n_splits):
    """make_case's rows (seq_len-0 rows on real and -1 pages, a -1 entry
    inside a range, a row of only -1 pages) at 1 to nb (5) splits."""
    case = make_case(7 * r + D, r=r, D=D, block=8, quantized=quantized)
    _split_check(case, cuda_device, n_splits)


@pytest.mark.cuda
@pytest.mark.parametrize("n_splits", (None, 1, 2, 3, 16, 32))
@pytest.mark.parametrize("quantized", (False, True), ids=("fp32", "int8"))
@pytest.mark.parametrize("rows", (8, 64))
def test_kernel_at_serving_shapes_and_splits(cuda_device, quantized, rows,
                                             n_splits):
    """The serving shapes (block 64, 32 pages a row) at the wrapper's rule
    (None) and forced split counts, up to one page per split."""
    case = serving_rows(rows, quantized=quantized, seed=rows)
    if n_splits is None:
        args, kw = _on(case, cuda_device)
        got = paged_decode_attention(*args, **kw)
        torch.testing.assert_close(
            got, paged_decode_attention_reference(*args, **kw), **TOL)
    else:
        _split_check(case, cuda_device, n_splits)


@pytest.mark.cuda
@pytest.mark.parametrize("block", (24, 128))
def test_kernel_takes_pages_of_any_length(cuda_device, block):
    """Pages shorter than a 64-slot tile and not dividing it (24), and
    longer than one tile (128)."""
    case = make_case(block, r=2, D=32, block=block, quantized=False)
    for n in (1, 3):
        _split_check(case, cuda_device, n)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", (False, True), ids=("fp32", "int8"))
def test_split_kernel_is_deterministic(cuda_device, quantized):
    """The splits merge in split order: two calls are bitwise equal."""
    args, kw = _on(serving_rows(8, quantized=quantized), cuda_device)
    first = paged_decode_attention(*args, **kw)
    for _ in range(3):
        assert torch.equal(paged_decode_attention(*args, **kw), first)


# -- the call shape of speculative verify ----------------------------------------

def verify_rows(requests: int = 8, k: int = 4, *, quantized: bool,
                block: int = 64, nb: int = 32, seed: int = 0):
    """Speculative verify's call: each of ``requests`` requests sends k+1
    rows that share its block table of ``nb`` pages, with seq_lens
    start+1 .. start+k+1 (start = nb * block - k - 1, so that the last row
    fills the table), at qwen2-0.5b's heads over a pool of requests * nb
    pages, the count of ``serving_rows``."""
    rng = np.random.default_rng(seed)
    N = requests * nb
    tables = rng.permutation(N).astype(np.int32).reshape(requests, nb)
    start = nb * block - k - 1
    bt = np.repeat(tables, k + 1, axis=0)
    lens = np.tile(np.arange(start + 1, start + k + 2, dtype=np.int32),
                   requests)
    case = dict(q=rng.standard_normal((len(lens), 14, 64)).astype(np.float32),
                block_tables=bt, seq_lens=lens)
    shape = (KV, N, block, 64)
    if quantized:
        case["k_pages"] = rng.integers(-127, 128, shape).astype(np.int8)
        case["v_pages"] = rng.integers(-127, 128, shape).astype(np.int8)
        case["k_scales"] = rng.uniform(0.1, 3.0, (KV, N)).astype(np.float32)
        case["v_scales"] = rng.uniform(0.1, 3.0, (KV, N)).astype(np.float32)
    else:
        case["k_pages"] = rng.standard_normal(shape).astype(np.float32)
        case["v_pages"] = rng.standard_normal(shape).astype(np.float32)
    return case


def rule_splits(args, quantized: bool) -> int:
    """The split count the wrapper's rule gives these arguments."""
    q, _, _, bt, _ = args
    B, H, D = q.shape
    groups = B * KV * -(-(H // KV) // ROW_GROUP)
    return len(split_ranges(bt.shape[1], choose_splits(
        groups, bt.shape[1],
        torch.cuda.get_device_properties(q.device).multi_processor_count,
        _blocks_per_sm(q.get_device(), quantized, D, bt.shape[1]))))


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", (False, True), ids=("fp32", "int8"))
@pytest.mark.parametrize("k", (1, 3, 4))
def test_kernel_at_the_verify_shape(cuda_device, quantized, k):
    """8 requests x (k+1) rows on shared tables: the wrapper against the
    plain version and against the split rule at the rule's count."""
    args, kw = _on(verify_rows(8, k, quantized=quantized, seed=k),
                   cuda_device)
    got = paged_decode_attention(*args, **kw)
    torch.testing.assert_close(
        got, paged_decode_attention_reference(*args, **kw), **TOL)
    torch.testing.assert_close(got, paged_decode_attention_split_reference(
        *args, **kw, n_splits=rule_splits(args, quantized)), **TOL)


def drive(cfg, backend, prompts):
    """``prompts`` (prompt length, max new tokens[, stream]) through the
    port's scheduler and ``backend`` to the end; prompts of one stream
    share their tokens (by default each its own).  Returns the token
    streams and the number of speculative plans."""
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import Scheduler
    sched = Scheduler(cfg)
    reqs = []
    for i, (n, max_new, *stream) in enumerate(prompts):
        r = Request(text="", max_new_tokens=max_new, req_id=i)
        s = stream[0] if stream else i + 1
        r.prompt_tokens = [3 + (((s << 10) + j) % 100) for j in range(n)]
        sched.add_request(r)
        reqs.append(r)
    specs = step = 0
    while sched.has_work and step < 500:
        plan = sched.schedule()
        if plan is None:
            break
        step += 1
        specs += plan.speculative
        for req in sched.complete_step(plan, float(step),
                                       backend.execute(plan)):
            backend.release(req.req_id)
    return [list(r.generated) for r in reqs], specs


@pytest.mark.cuda
def test_speculative_streams_equal_stepwise_at_serve_widths(cuda_device):
    """Stepwise greedy decode and speculative decode (k 4, draft and target
    of one seed, both on the card) at the serve runs' widths (qwen2-0.5b's
    heads and vocab, block 64), 8 requests of 512 prompt tokens and 16 new
    ones: B1 splits a verify call (40 rows) in fewer parts than a decode
    step (8 rows)."""
    from repro_torch.backend import ARCH_WIDTHS
    from repro_torch.backend.surrogate import draw_params
    from repro_torch.backend.torch_backend import TorchBackend
    from repro_torch.serving.scheduler import SchedulerConfig
    from repro_torch.spec import SpeculativeBackend
    widths = ARCH_WIDTHS["qwen2-0.5b"]
    params = draw_params(seed=0, **widths)
    prompts = [(512, 16)] * 8

    def cfg(spec_k):
        return SchedulerConfig(block_size=64, kv_capacity_tokens=128 * 64,
                               max_num_seqs=8, speculative_k=spec_k)

    def leaf(c):
        return TorchBackend(device=cuda_device, params=params, block_size=64,
                            num_blocks=c.num_kv_blocks, **widths)
    stepwise, _ = drive(cfg(0), leaf(cfg(0)), prompts)
    spec, n_spec = drive(cfg(4), SpeculativeBackend(leaf(cfg(4)),
                                                    leaf(cfg(4))), prompts)
    assert n_spec >= 1
    assert spec == stepwise


_SMALL = dict(max_num_seqs=8, max_tokens_per_step=64, prefill_chunk=16,
              block_size=8)
# (scheduler settings, prompts) at the toy width (block 8, vocab 128):
# swap churn; prompts that share a prefix through the prefix cache; and
# k-step plans under swap churn, which the card's captured loop replays
STREAM_RUNS = {
    "swap": (dict(_SMALL, enable_prefix_cache=False,
                  kv_capacity_tokens=12 * 8, preemption_policy="swap",
                  swap_capacity_tokens=32 * 8),
             ((12, 12), (20, 9), (9, 12))),
    "prefix": (dict(_SMALL, enable_prefix_cache=True,
                    kv_capacity_tokens=512),
               ((21, 3, 1), (40, 5, 2), (21, 2, 1), (9, 4, 3))),
    "k4-swap": (dict(_SMALL, enable_prefix_cache=False,
                     kv_capacity_tokens=96, preemption_policy="swap",
                     swap_capacity_tokens=256, max_steps_per_dispatch=4),
                ((40, 24, 1), (37, 24, 2))),
}
# (target, the cpu draft's seed: the target's, another, or None for no
# speculative decode)
STREAM_TARGETS = {"torch": ("torch", 0), "torch-other-draft": ("torch", 7),
                  "hybrid": ("hybrid", 0), "hybrid-other-draft": ("hybrid", 7),
                  "hybrid-int8": ("hybrid-int8", None)}


@pytest.mark.cuda
@pytest.mark.parametrize("run", sorted(STREAM_RUNS))
@pytest.mark.parametrize("target,draft_seed", STREAM_TARGETS.values(),
                         ids=STREAM_TARGETS)
def test_speculative_streams_equal_stepwise_on_card(cuda_device, target,
                                                    draft_seed, run):
    """Greedy speculative decode with the target on the card and a cpu
    draft (of the target's weights, or of other weights, so that verify
    rejects) emits stepwise greedy decode's tokens on the card; verify
    calls and decode steps reach B1 with other row counts.  That stepwise
    stream equals the same composition's with the CPU in the card's place:
    ``TorchBackend``, its k-step plans replayed from captured graphs; the
    hybrid (prefill on the card, decode on the CPU, fp32 or an int8 decode
    tier) against the all-CPU hybrid.  An int8 decode tier runs no
    speculative decode here: a rejected draft's K/V can raise a page's
    amax, which requantizes the page's earlier slots, so its streams may
    leave stepwise decode's."""
    from repro_torch.backend.cpu_decode import CpuDecodeBackend
    from repro_torch.backend.hybrid import HybridBackend
    from repro_torch.backend.torch_backend import TorchBackend
    from repro_torch.serving.scheduler import SchedulerConfig
    from repro_torch.spec import SpeculativeBackend
    settings, prompts = STREAM_RUNS[run]
    kv_dtype = "int8" if target == "hybrid-int8" else "float32"

    def run_on(device, spec_k: int):
        cfg = SchedulerConfig(**settings, speculative_k=spec_k)
        kw = dict(block_size=8, num_blocks=cfg.num_kv_blocks,
                  num_swap_blocks=cfg.num_swap_blocks,
                  copy_streams=cfg.copy_streams, vocab=128)
        be = leaf = TorchBackend(device=device,
                                 max_steps=cfg.max_steps_per_dispatch, **kw)
        if target != "torch":
            be = HybridBackend(be, CpuDecodeBackend(**kw, kv_dtype=kv_dtype),
                               copy_streams=cfg.copy_streams)
        if spec_k:
            be = SpeculativeBackend(CpuDecodeBackend(**kw, seed=draft_seed),
                                    be)
        streams, n_spec = drive(cfg, be, prompts)
        return streams, n_spec, leaf

    stepwise, _, leaf = run_on(cuda_device, 0)
    if target == "torch" and settings.get("max_steps_per_dispatch", 1) > 1:
        assert leaf.graphs.replays > 0
    assert stepwise == run_on("cpu", 0)[0]
    if draft_seed is None:
        return
    before = paged_decode_attention.launches
    spec, n_spec, _ = run_on(cuda_device, 4)
    assert n_spec >= 1 and paged_decode_attention.launches > before
    assert spec == stepwise
