"""The captured k-step decode loops' bodies, on the CPU.

On the card ``TorchBackend._decode_multi`` and ``Model.decode_multi`` run
one step of their loop as a replayed CUDA graph (``kernels._graph``); CPU
tensors run the same step eagerly on the same static buffers, so these
tests reach everything but the capture itself:

* ``TorchBackend(device="cpu")``'s padded loop against
  ``JaxBackend._decode_multi`` (the Pallas kernel in interpret mode) with
  the same weights and pools: 1, 3 and 5 rows (padded to 2, 4 and 8),
  ragged tables, budgets below k, an EOS midway; streams identical, pages
  within 1e-5 (float32, sums in another order); then the scheduler
  workloads under swap churn in lockstep (``drive_lockstep``);
* ``Model.decode_multi`` against ``repro.models.model.decode_multi`` on
  the ten architectures at the conftest ``tiny`` size, with and without
  ``eos_id``: tokens identical, lengths equal, caches within 1e-4 (as
  tests/test_torch_models.py holds them);
* ``GraphCache`` with stubs in place of ``torch.cuda.CUDAGraph`` and its
  streams: a key's entry is reused, new storage captures anew, the cache
  keeps its bound, the counters of every registered wrapper (routes too)
  rise by the captured launches times the replays and not at capture, a
  failed capture raises and leaves the counters as they were; the serving
  leaf keys its graphs by bucket and not by k, within the bound its pool
  implies, and ``make_backend`` gives it the scheduler's largest k;
* B2's checks, run once per call signature, still refuse a bad call after
  a good one; M-RoPE's angles against the reference's.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backend.jax_backend import JaxBackend
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.backend.torch_backend import TorchBackend
from repro_torch.kernels import _build, _graph
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.mamba_scan import mamba1_scan
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_reference

from conftest import tiny
from test_torch_backend import CHURN, CONFORMANCE, _BASE, _params, \
    drive_lockstep
from test_torch_models import ARCHS, frames, leaves, mrope, perturb, \
    port_config

BLOCK, VOCAB, NUM_BLOCKS = 8, 128, 96
PAGE_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)

# ---------------------------------------------------------------------------
# the serving leaf's loop against JaxBackend's scan
# ---------------------------------------------------------------------------


def leaf_pair():
    """A JaxBackend (interpret mode) and a TorchBackend on the CPU with the
    same weights and the same random pools."""
    kw = dict(block_size=BLOCK, num_blocks=NUM_BLOCKS, vocab=VOCAB)
    jbe = JaxBackend(interpret=True, **kw)
    tbe = TorchBackend(device="cpu", params=_params(jbe), **kw)
    rng = np.random.default_rng(3)
    for name in ("k_pages", "v_pages"):
        pool = rng.standard_normal(getattr(jbe, name).shape).astype(
            np.float32)
        getattr(jbe, name)[...] = pool
        getattr(tbe, name)[:, :NUM_BLOCKS] = torch.from_numpy(pool)
    return jbe, tbe


def loop_inputs(rows: int, k: int, seed: int):
    """Ragged tables of distinct pages, start positions that cross a page
    boundary within the k steps for some rows, budgets from 1 to k (the
    first row's below k)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(NUM_BLOCKS)
    rids = [7 + 3 * i for i in range(rows)]
    tables, start, first, budgets, used = {}, {}, {}, {}, 0
    for i, rid in enumerate(rids):
        n = int(rng.integers(1, 6))
        tables[rid] = [int(p) for p in perm[used:used + n]]
        used += n
        start[rid] = BLOCK * n - int(rng.integers(k, BLOCK + 1))
        first[rid] = int(rng.integers(0, VOCAB))
        budgets[rid] = k - 1 if i == 0 else int(rng.integers(1, k + 1))
    return rids, tables, start, first, budgets


@pytest.mark.parametrize("rows", (1, 3, 5))
def test_padded_loop_equals_the_jax_scan(rows):
    k = 4
    rids, tables, start, first, budgets = loop_inputs(rows, k, seed=rows)
    free = {rid: None for rid in rids}
    _, probe = leaf_pair()
    stream = probe._decode_multi(rids, tables, start, first, budgets, free,
                                 k)
    # an EOS: the last row's second token (its first, if it has one)
    last = rids[-1]
    own = [row[last] for row in stream if last in row]
    eos = {**free, last: own[min(1, len(own) - 1)]}
    for eos_ids in (free, eos):
        jbe, tbe = leaf_pair()
        want = jbe._decode_multi(rids, tables, start, first, budgets,
                                 eos_ids, k)
        got = tbe._decode_multi(rids, tables, start, first, budgets,
                                eos_ids, k)
        assert got == want
        for name in ("k_pages", "v_pages"):
            np.testing.assert_allclose(
                getattr(tbe, name)[:, :NUM_BLOCKS].numpy(),
                getattr(jbe, name)[:, :NUM_BLOCKS], **PAGE_TOL)
    assert sum(last in row for row in want) <= 2       # stopped at its EOS


@pytest.mark.parametrize("specs", (CONFORMANCE + CHURN, CHURN),
                         ids=("mixed", "churn"))
def test_k_step_loop_in_lockstep_under_swap_churn(specs):
    cfg_kw = dict(_BASE, block_size=BLOCK, enable_prefix_cache=False,
                  kv_capacity_tokens=14 * BLOCK, preemption_policy="swap",
                  swap_capacity_tokens=40 * BLOCK,
                  max_steps_per_dispatch=4)

    def make_pair(cfg):
        kw = dict(block_size=cfg.block_size, num_blocks=cfg.num_kv_blocks,
                  num_swap_blocks=cfg.num_swap_blocks, vocab=VOCAB)
        jbe = JaxBackend(interpret=True, **kw)
        return jbe, TorchBackend(device="cpu", params=_params(jbe), **kw)
    jreqs, treqs, _, _, macros = drive_lockstep(cfg_kw, specs, make_pair)
    assert macros >= 1
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]


# ---------------------------------------------------------------------------
# the model path's loop against the reference's decode_multi
# ---------------------------------------------------------------------------

B, S, N = 2, 12, 6


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """The reference and the port from the same perturbed weights, each
    after its own prefill of the same prompt, caches grown by N."""
    jcfg = tiny(request.param)
    tcfg = port_config(jcfg)
    rng = np.random.default_rng(11)
    tree = perturb(jax.tree.map(np.asarray,
                                JM.init_params(jax.random.PRNGKey(1), jcfg)),
                   rng)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = params_from_reference(tree, tcfg, "cpu")
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    ext, step_ext = {}, {}
    if jcfg.family == "vlm":
        ext = {"mrope_positions": mrope(0, S)}
        step_ext = {"mrope_positions": mrope(S, 1)}
    if jcfg.family == "audio":
        ext = {"frames": frames(jcfg)}
    logits, jcache = jax.jit(JM.prefill, static_argnums=(1,))(
        jparams, jcfg, toks, {k: jnp.asarray(v) for k, v in ext.items()})
    specs = JM.cache_specs(jcfg, B, S + N)
    jcache = jax.tree.map(lambda c, s: jnp.pad(
        c, [(0, d - g) for g, d in zip(c.shape, s.shape)]), jcache, specs)
    _, tcache = model.prefill(torch.from_numpy(toks),
                              {k: torch.from_numpy(v) for k, v in ext.items()})
    tcache = TM.grow_cache(tcache, tcfg, B, S + N)
    first = np.asarray(logits[:, 0, :jcfg.vocab_size].argmax(-1),
                       np.int32)[:, None]
    return dict(jcfg=jcfg, jparams=jparams, jcache=jcache, model=model,
                tcache=tcache, first=first, step_ext=step_ext)


def _both_multi(p, eos_id):
    j_multi = jax.jit(JM.decode_multi, static_argnums=(1, 5),
                      static_argnames=("eos_id",))
    jt, jc, jl = j_multi(p["jparams"], p["jcfg"], jnp.asarray(p["first"]),
                         p["jcache"], jnp.int32(S), N,
                         {k: jnp.asarray(v) for k, v in p["step_ext"].items()},
                         eos_id=eos_id)
    cache = {s: {k: {n: t.clone() for n, t in e.items()}
                 for k, e in layers.items()}
             for s, layers in p["tcache"].items()}
    tt, tc, tl = p["model"].decode_multi(
        torch.from_numpy(p["first"]), cache, S, N,
        {k: torch.from_numpy(v) for k, v in p["step_ext"].items()},
        eos_id=eos_id)
    return (np.asarray(jt), jc, int(jl)), (tt.numpy(), tc, int(tl))


def test_static_buffer_loop_equals_the_reference(pair):
    (jt, jc, jl), (tt, tc, tl) = _both_multi(pair, None)
    np.testing.assert_array_equal(tt, jt)
    assert tl == jl == S + N
    got = dict(leaves(tc))
    for key, want in leaves(jc):
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want),
                                   **MODEL_TOL, err_msg=key)
    pair["free"] = tt


def test_static_buffer_loop_masks_eos_as_the_reference(pair):
    free = pair.get("free")
    if free is None:
        free = _both_multi(pair, None)[1][0]
    eos = int(free[0, N // 2])
    (jt, jc, jl), (tt, tc, tl) = _both_multi(pair, eos)
    np.testing.assert_array_equal(tt, jt)
    stop = int(np.argmax(free[0] == eos))
    assert (tt[0, stop:] == eos).all()
    assert tl == jl == S + N
    got = dict(leaves(tc))
    for key, want in leaves(jc):
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want),
                                   **MODEL_TOL, err_msg=key)


# ---------------------------------------------------------------------------
# GraphCache with stubs for the card's graph and streams
# ---------------------------------------------------------------------------


class _StubGraph:
    made = []

    def __init__(self):
        self.replays = 0
        self.state = "new"
        _StubGraph.made.append(self)

    def capture_begin(self, pool=None):
        self.state = "capturing"

    def capture_end(self):
        self.state = "captured"

    def replay(self):
        assert self.state == "captured"
        self.replays += 1


class _StubStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def stub_cuda(monkeypatch):
    """torch.cuda's graph, streams and sync-debug switch as stubs; yields
    the list of sync-debug modes set."""
    modes = ["default"]
    _StubGraph.made = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "Stream", _StubStream)
    monkeypatch.setattr(torch.cuda, "current_stream", _StubStream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    before = _build.launch_counts()
    yield modes
    for w, (n, routes) in zip(_build.COUNTED, before):
        w.launches = n
        if routes:
            w.launches_by_route.update(routes)


def _step(ran, modes):
    """A step that 'launches' B1 twice and B4 once, as wrappers count."""
    def step():
        assert modes[-1] == "error"
        ran.append(1)
        paged_decode_attention.launches += 2
        mamba1_scan.launches += 1
    return step


def test_graph_books_count_replays_not_the_capture(stub_cuda):
    graphs, ran = _graph.GraphCache(capacity=4), []
    b1, b4 = paged_decode_attention.launches, mamba1_scan.launches
    entry = graphs.entry(("k", 1), lambda: "state")
    graphs.run(entry, _step(ran, stub_cuda), 1)
    # warm-up (a real step) and capture ran the step; only the warm-up
    # counts, and no replay ran
    assert len(ran) == 2
    assert {w: (n, r) for w, n, r in entry.books} == {
        paged_decode_attention: (2, {}), mamba1_scan: (1, {})}
    assert paged_decode_attention.launches - b1 == 2
    assert mamba1_scan.launches - b4 == 1
    assert entry.graph.replays == 0 and graphs.captures == 1
    graphs.run(graphs.entry(("k", 1), lambda: "other"), _step(ran, stub_cuda),
               5)
    assert len(ran) == 2 and entry.graph.replays == 5
    assert paged_decode_attention.launches - b1 == 2 + 5 * 2
    assert mamba1_scan.launches - b4 == 1 + 5
    assert graphs.replays == 5 and stub_cuda[-1] == "default"


def test_graph_reused_per_key_and_anew_for_new_storage(stub_cuda):
    graphs, ran = _graph.GraphCache(capacity=4), []
    a, b = torch.zeros(4), torch.zeros(4)
    first = graphs.entry(_graph.storage_key(a), lambda: "a")
    graphs.run(first, _step(ran, stub_cuda), 3)
    assert graphs.entry(_graph.storage_key(a), lambda: "x") is first
    assert _graph.storage_key(a) == _graph.storage_key(a.view(4))
    second = graphs.entry(_graph.storage_key(b), lambda: "b")
    assert second is not first and second.graph is None
    graphs.run(second, _step(ran, stub_cuda), 3)
    assert graphs.captures == 2 and len(graphs) == 2
    assert _graph.storage_key(a) != _graph.storage_key(a[:2])


def test_graph_cache_keeps_its_bound(stub_cuda):
    graphs, ran = _graph.GraphCache(capacity=2), []
    for key in ("a", "b", "a", "c"):
        graphs.run(graphs.entry(key, lambda: key), _step(ran, stub_cuda), 2)
    assert len(graphs) == 2 and graphs.captures == 3
    # "b" was the least recently used; "a" survives, "b" captures anew
    assert graphs.entry("a", lambda: "new").state == "a"
    assert graphs.entry("b", lambda: "new").graph is None
    with pytest.raises(ValueError):
        _graph.GraphCache(capacity=0)


def test_failed_capture_raises_and_keeps_the_books(stub_cuda):
    graphs = _graph.GraphCache(capacity=4)
    b1 = paged_decode_attention.launches
    calls = []

    def step():
        calls.append(1)
        paged_decode_attention.launches += 1
        if len(calls) == 2:             # inside the capture
            raise RuntimeError("operation not permitted when capturing")
    entry = graphs.entry("k", lambda: None)
    with pytest.raises(RuntimeError, match="capturing"):
        graphs.run(entry, step, 4)
    assert entry.graph is None and graphs.captures == 0
    assert paged_decode_attention.launches - b1 == 1        # the warm-up
    assert _StubGraph.made[-1].state == "captured"          # ended
    assert stub_cuda[-1] == "default"


def test_books_keep_every_registered_wrapper_and_its_routes(stub_cuda):
    # the books are generic: a wrapper off the decode path (B3, with its
    # launches by route) that runs inside a step is booked like B1
    assert {paged_decode_attention, mamba1_scan,
            flash_attention_bhsd} <= set(_build.COUNTED)
    graphs = _graph.GraphCache(capacity=4)
    n0 = flash_attention_bhsd.launches
    r0 = dict(flash_attention_bhsd.launches_by_route)

    def step():
        flash_attention_bhsd.launches += 2
        flash_attention_bhsd.launches_by_route["wgmma"] += 2
    graphs.run(graphs.entry("k", lambda: None), step, 4)
    # the warm-up and 3 replays ran, the capture did not
    assert flash_attention_bhsd.launches - n0 == 2 * 4
    assert flash_attention_bhsd.launches_by_route["wgmma"] - r0["wgmma"] \
        == 2 * 4
    assert flash_attention_bhsd.launches_by_route["simt"] == r0["simt"]


def test_serving_leaf_keys_by_bucket_not_by_k(stub_cuda):
    # the step runs eagerly on the CPU under the stubs (its output is not
    # checked here); what counts is which calls share a graph
    from repro_torch.backend.torch_backend import _n_buckets
    kw = dict(block_size=BLOCK, num_blocks=NUM_BLOCKS, vocab=VOCAB)
    be = TorchBackend(device="cpu", max_steps=4, **kw)
    be.graphs = _graph.GraphCache(capacity=_n_buckets(NUM_BLOCKS) ** 2)
    rids, tables, start, first, budgets = loop_inputs(3, 4, seed=1)
    free = {rid: None for rid in rids}
    for k in (4, 3, 1, 4):              # a request's tail shrinks k
        be._decode_multi(rids, tables, start, first,
                         {rid: min(b, k) for rid, b in budgets.items()},
                         free, k)
    assert be.graphs.captures == 1 and len(be.graphs) == 1
    assert be.graphs.replays == 3 + 3 + 1 + 4     # the first call captured
    be._decode_multi(rids[:1], tables, start, first, budgets, free, 4)
    assert be.graphs.captures == 2           # rows 1 pad to 2: a new bucket


def test_serving_leaf_bound_covers_every_bucket():
    from repro_torch.backend.torch_backend import _n_buckets, _pow2_at_least
    for n in (1, 2, 3, 4, 5, 96, 1536, 1537):
        assert _n_buckets(n) == len({_pow2_at_least(m, 2)
                                     for m in range(1, n + 1)})
    assert _n_buckets(1536) == 11


def test_make_backend_gives_the_leaf_the_largest_k():
    from repro_torch.backend import make_backend
    from repro_torch.serving.scheduler import SchedulerConfig
    kw = dict(kv_capacity_tokens=64 * 16, block_size=16)
    leaf = make_backend("torch", torch_device="cpu",
                        scheduler_cfg=SchedulerConfig(
                            max_steps_per_dispatch=4, **kw))
    assert leaf.max_steps == 4
    spec = make_backend("torch", torch_device="cpu", draft_backend="torch",
                        scheduler_cfg=SchedulerConfig(speculative_k=3, **kw))
    assert spec.draft.max_steps == spec.target.max_steps == 3


# ---------------------------------------------------------------------------
# capture-safety repairs
# ---------------------------------------------------------------------------


def test_decode_cached_checks_still_refuse_after_a_valid_call():
    q = torch.zeros(2, 4, 16)
    k = torch.zeros(2, 2, 8, 16)
    clen = torch.full((2,), 8, dtype=torch.int32)
    pos = torch.arange(8, dtype=torch.int32).expand(2, 8)
    for _ in range(2):
        DA._checked(q, k, k, clen, pos, None)
        DA._checked(q, k, k, clen, pos, 4)
    with pytest.raises(TypeError):
        DA._checked(q, k, k, clen.long(), pos, None)
    with pytest.raises(TypeError):
        DA._checked(q.double(), k, k, clen, pos, None)
    with pytest.raises(ValueError):
        DA._checked(q, k, k, clen, pos, 0)
    with pytest.raises(ValueError):
        DA._checked(q, k[:, :, :, :8], k[:, :, :, :8], clen, pos, None)
    with pytest.raises(ValueError):
        DA._checked(q, k, k, clen, pos.t().contiguous().t(), None)
    misaligned = torch.zeros(q.numel() + 2)[2:].view(q.shape)  # 8 bytes in
    with pytest.raises(ValueError, match="aligned"):
        DA._checked(misaligned, k, k, clen, pos, None)


@pytest.mark.parametrize("sections", ((2, 3, 3), (16, 24, 24)))
def test_mrope_angles_match_the_reference(sections):
    head_dim = 2 * sum(sections)
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 4096, (3, 2, 5)).astype(np.int32)
    x = rng.standard_normal((2, 5, 3, head_dim)).astype(np.float32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                         sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_workers_report_their_leaves_graph_replays():
    from types import SimpleNamespace

    from repro_torch.core.engine import _graph_books
    leaf = SimpleNamespace(graphs=SimpleNamespace(captures=2, capture_s=0.5,
                                                  replays=7))
    draft = SimpleNamespace(graphs=SimpleNamespace(captures=1,
                                                   capture_s=0.25, replays=3))
    one = {"graph_captures": 2, "graph_capture_s": 0.5, "graph_replays": 7}
    assert _graph_books(leaf) == one
    assert _graph_books(SimpleNamespace(target=leaf, draft=draft)) == {
        "graph_captures": 3, "graph_capture_s": 0.75, "graph_replays": 10}
    assert _graph_books(SimpleNamespace(
        prefill_backend=leaf, decode_backend=SimpleNamespace())) == one
    assert _graph_books(TorchBackend(device="cpu", block_size=8,
                                     num_blocks=4)) == {
        "graph_captures": 0, "graph_capture_s": 0.0, "graph_replays": 0}
