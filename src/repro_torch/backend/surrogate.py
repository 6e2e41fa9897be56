"""Shared paged-KV surrogate model for the port's physical backends.

The torch version of ``src/repro/backend/surrogate.py``.  A deliberately
small transformer surrogate (fixed random projections from token
embeddings to Q/K/V and to logits) whose KV lives in a page pool
``[KV, num_blocks + 1, block_size, D]`` on the backend's device,
addressed through the block tables the scheduler broadcasts, plus a host
tier (pinned when the device is a card) that backs swap-to-host
preemption.  ``PagedSurrogateBackend`` implements all of that once and
leaves one seam, ``_attend``, for ``TorchBackend`` to fill with the paged
decode attention kernel.

What the port keeps from the reference, so that the two packages sample
the same tokens for the same plans:

* the weights are drawn by ``draw_params`` exactly as the reference draws
  them (numpy ``default_rng(seed)``, same shapes, same order), and reach
  the device through ``params_from_numpy``; ``params=`` carries another
  backend's arrays across explicitly;
* all arithmetic is float32;
* swap directives apply in contract order (``swap_outs``, ``restores``,
  then compute), deferred to the next ``execute`` when ``copy_streams``
  is on (``repro_torch.core.copyengine``);
* int8 pools requantize on amax growth slot by slot, in the reference's
  write order, so the codes stay identical; fp32 writes of one chunk are
  one scatter.

In a traced run (``repro_torch.profiling``) ``execute`` records four
trace-only spans of the plan's step, wherever the leaf does their work
(``profiling.LEAF_SITES``): ``leaf_pack`` builds a step's host-side
inputs, ``leaf_copy`` copies them to the device, ``leaf_launch`` enqueues
the device work, ``leaf_read`` reads the sampled tokens back.  No span
synchronizes, so ``leaf_launch`` is enqueue time and a wait on the device
shows in ``leaf_copy`` or ``leaf_read``.  Untraced, each span is one
shared no-op context.

What differs: the pools live on the device, tables are not remapped to a
compact pool, and a step's query projection and greedy sampling are
batched on the device with one host read of the sampled ids.  Page
``num_blocks`` is a scratch page that only masked rows of a macro-plan
write to.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import profiling
from repro_torch.backend.base import PinnedLRU, StepResult
from repro_torch.core.copyengine import DeferredCopies
from repro_torch.device import resolve_device
from repro_torch.serving.scheduler import StepPlan

PARAM_KEYS = ("embed", "wq", "wk", "wv", "wo")

# every leaf span of an untraced execute
_UNTRACED = contextlib.nullcontext()


def draw_params(*, vocab: int, n_heads: int, n_kv_heads: int,
                head_dim: int, seed: int) -> Dict[str, np.ndarray]:
    """The surrogate's weights as float32 numpy arrays, drawn exactly as
    ``src/repro/backend/surrogate.py`` draws them, so one seed gives the
    same weights in both packages."""
    embed_dim = n_heads * head_dim
    rng = np.random.default_rng(seed)
    scale = 1.0 / np.sqrt(embed_dim)
    embed = rng.standard_normal((vocab, embed_dim)).astype(np.float32)
    wq = (rng.standard_normal(
        (embed_dim, n_heads * head_dim)) * scale).astype(np.float32)
    wk = (rng.standard_normal(
        (embed_dim, n_kv_heads * head_dim)) * scale).astype(np.float32)
    wv = (rng.standard_normal(
        (embed_dim, n_kv_heads * head_dim)) * scale).astype(np.float32)
    wo = (rng.standard_normal((embed_dim, vocab)) * scale).astype(np.float32)
    return {"embed": embed, "wq": wq, "wk": wk, "wv": wv, "wo": wo}


def params_from_numpy(arrays: Dict[str, np.ndarray],
                      device="cpu") -> Dict[str, torch.Tensor]:
    """float32 tensors on ``device`` for the keys ``PARAM_KEYS``."""
    return {k: torch.from_numpy(
        np.ascontiguousarray(arrays[k], dtype=np.float32)).to(device)
        for k in PARAM_KEYS}


class PagedSurrogateBackend:
    """Base for backends that own physical pages (see module docstring)."""

    def __init__(self, *, block_size: int, num_blocks: int,
                 num_swap_blocks: int = 0, copy_streams: int = 0,
                 n_heads: int = 4, n_kv_heads: int = 2, head_dim: int = 16,
                 vocab: int = 256, seed: int = 0, kv_dtype: str = "float32",
                 device=None, params: Optional[Dict[str, np.ndarray]] = None):
        if kv_dtype not in ("float32", "int8"):
            raise ValueError(f"kv_dtype must be float32|int8, got {kv_dtype}")
        self.device = resolve_device(device)
        self.kv_dtype = kv_dtype
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.num_swap_blocks = num_swap_blocks
        # copy_streams >= 1: swap/restore page copies are DEFERRED to the
        # next execute() — the epoch boundary of the async copy engine
        # (docs/copy_engine.md); safe only under the scheduler's matching
        # IN_FLIGHT bookkeeping (SchedulerConfig.copy_streams)
        self.copy_streams = copy_streams
        self._deferred = DeferredCopies()
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.vocab = vocab
        self._embed_dim = n_heads * head_dim
        if params is None:
            params = draw_params(vocab=vocab, n_heads=n_heads,
                                 n_kv_heads=n_kv_heads, head_dim=head_dim,
                                 seed=seed)
        p = params_from_numpy(params, self.device)
        E = self._embed_dim
        want = {"embed": (vocab, E), "wq": (E, n_heads * head_dim),
                "wk": (E, n_kv_heads * head_dim),
                "wv": (E, n_kv_heads * head_dim), "wo": (E, vocab)}
        for k, shape in want.items():
            if tuple(p[k].shape) != shape:
                raise ValueError(f"params[{k!r}] has shape "
                                 f"{tuple(p[k].shape)}, want {shape}")
        self._embed, self._wq, self._wk, self._wv, self._wo = (
            p[k] for k in PARAM_KEYS)
        # the page pool the block tables index, plus one scratch page at
        # index num_blocks; int8 mode carries per-(kv-head, page) scales
        dt = torch.int8 if kv_dtype == "int8" else torch.float32
        pool = (n_kv_heads, num_blocks + 1, block_size, head_dim)
        self.k_pages = torch.zeros(pool, dtype=dt, device=self.device)
        self.v_pages = torch.zeros_like(self.k_pages)
        if kv_dtype == "int8":
            self.k_scales = torch.zeros(pool[:2], dtype=torch.float32,
                                        device=self.device)
            self.v_scales = torch.zeros_like(self.k_scales)
        else:
            self.k_scales = self.v_scales = None
        # host swap tier, same dtype as the device pool (int8 swaps move
        # the codes and their scales)
        self.k_swap = self.v_swap = None
        self.k_swap_scales = self.v_swap_scales = None
        if num_swap_blocks > 0:
            pin = self.device.type == "cuda"
            swap = (n_kv_heads, num_swap_blocks, block_size, head_dim)
            self.k_swap = torch.zeros(swap, dtype=dt, pin_memory=pin)
            self.v_swap = torch.zeros(swap, dtype=dt, pin_memory=pin)
            if kv_dtype == "int8":
                self.k_swap_scales = torch.zeros(swap[:2], pin_memory=pin)
                self.v_swap_scales = torch.zeros(swap[:2], pin_memory=pin)
        # rids parked in the host tier: their _seq_lens entry must survive
        # arbitrary churn until the restore arrives (base.Backend contract)
        self._swap_pinned: set = set()
        # req_id -> tokens in cache (see base.PinnedLRU for the aging story)
        self._seq_lens = PinnedLRU(pinned=self._swap_pinned)
        self._last_wall = 0.0
        # (profiler, step, phase) while a traced execute runs
        self._trace = None

    # -- projections ---------------------------------------------------------

    def _emb(self, tokens: torch.Tensor) -> torch.Tensor:
        return self._embed[tokens % self.vocab]

    def _kv(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        e = self._emb(tokens)                                  # [n, E]
        k = (e @ self._wk).view(-1, self.n_kv_heads, self.head_dim)
        v = (e @ self._wv).view(-1, self.n_kv_heads, self.head_dim)
        return k, v

    def _span(self, site: str):
        """The leaf span ``site`` of the plan ``execute`` runs, or the
        shared no-op context when it is not traced."""
        trace = self._trace
        if trace is None:
            return _UNTRACED
        prof, step, phase = trace
        return prof.span(site, step=step, phase=phase)

    def _write(self, chunks: Sequence[Tuple[List[int], int, Sequence[int]]]
               ) -> None:
        """Write K/V for each ``(table, start, tokens)`` chunk at positions
        ``start..`` of its table, chunks in order."""
        bs = self.block_size
        toks: List[int] = []
        pages: List[int] = []
        slots: List[int] = []
        with self._span("leaf_pack"):
            for table, start, tokens in chunks:
                for i, tok in enumerate(tokens):
                    pos = start + i
                    toks.append(int(tok))
                    pages.append(table[pos // bs])
                    slots.append(pos % bs)
            if not toks:
                return
            host = torch.tensor([toks, pages, slots], dtype=torch.int64)
        with self._span("leaf_copy"):
            idx = host.to(self.device)
        with self._span("leaf_launch"):
            k, v = self._kv(idx[0])                            # [n, KV, D]
            if self.kv_dtype == "int8":
                for i, (page, slot) in enumerate(zip(pages, slots)):
                    self._quant_store(self.k_pages, self.k_scales, page,
                                      slot, k[i])
                    self._quant_store(self.v_pages, self.v_scales, page,
                                      slot, v[i])
            else:
                self.k_pages[:, idx[1], idx[2]] = k.transpose(0, 1)
                self.v_pages[:, idx[1], idx[2]] = v.transpose(0, 1)

    @staticmethod
    def _quant_store(pages: torch.Tensor, scales: torch.Tensor, page: int,
                     slot: int, x: torch.Tensor) -> None:
        """Append ``x`` [KV, D] to an int8 page with per-(head, page)
        symmetric scales.  Heads whose new amax exceeds the page scale
        first requantize their existing codes to the grown scale
        (q' = round(q * s_old / s_new)); the ratio is taken in float64 and
        rounded to float32, as the reference's Python floats are.  No host
        sync: the per-head choice is a ``where``."""
        amax = x.abs().amax(dim=1)                             # [KV]
        old = scales[:, page].clone()
        grow = amax > old
        ratio = (old.double() / amax.double()).float()
        cur = pages[:, page].float()                           # [KV, bs, D]
        requant = torch.round(cur * ratio[:, None, None]).clamp_(-127, 127)
        pages[:, page] = torch.where((grow & (old > 0.0))[:, None, None],
                                     requant, cur).to(torch.int8)
        new = torch.where(grow, amax, old)
        scales[:, page] = new
        safe = torch.where(new > 0.0, new, torch.ones_like(new))
        codes = torch.round(x * (127.0 / safe)[:, None]).clamp_(-127, 127)
        pages[:, page, slot] = codes.to(torch.int8)

    def _gather_pages(self, idx: torch.Tensor):
        """fp32 (k, v) of pages ``idx``, dequantized if the pool is int8."""
        k = self.k_pages[:, idx]
        v = self.v_pages[:, idx]
        if self.kv_dtype == "int8":
            k = k.float() * (self.k_scales[:, idx][..., None, None] / 127.0)
            v = v.float() * (self.v_scales[:, idx][..., None, None] / 127.0)
        return k, v

    # whole-page movement across tiers: the prefill->decode handoff copy
    # is where fp32 -> int8 conversion lives (single-shot per-page scale)

    def export_pages(self, blocks: List[int]):
        """fp32 copies of whole pages (dequantized if int8), on the
        backend's device."""
        idx = torch.as_tensor(blocks, dtype=torch.int64, device=self.device)
        return self._gather_pages(idx)

    def import_pages(self, blocks: List[int], k: torch.Tensor,
                     v: torch.Tensor) -> None:
        """Install fp32 pages [KV, n, block, D]; quantize whole-page when
        this pool is int8."""
        idx = torch.as_tensor(blocks, dtype=torch.int64, device=self.device)
        k = k.to(self.device, torch.float32)
        v = v.to(self.device, torch.float32)
        if self.kv_dtype == "int8":
            for pages, scales, x in ((self.k_pages, self.k_scales, k),
                                     (self.v_pages, self.v_scales, v)):
                amax = x.abs().amax(dim=(2, 3))                # [KV, n]
                safe = torch.where(amax > 0.0, amax, torch.ones_like(amax))
                pages[:, idx] = torch.round(
                    x * (127.0 / safe)[:, :, None, None]).clamp_(
                        -127, 127).to(torch.int8)
                scales[:, idx] = amax
        else:
            self.k_pages[:, idx] = k
            self.v_pages[:, idx] = v

    def _track(self, rid: int, seq_len: int) -> None:
        self._seq_lens.put(rid, seq_len)

    # -- host<->device page movement -----------------------------------------

    def _copy_out(self, pairs: List[tuple]) -> None:
        dev = torch.tensor([d for d, _ in pairs],
                           dtype=torch.int64).to(self.device)
        host = torch.tensor([h for _, h in pairs], dtype=torch.int64)
        self.k_swap[:, host] = self.k_pages[:, dev].cpu()
        self.v_swap[:, host] = self.v_pages[:, dev].cpu()
        if self.kv_dtype == "int8":
            self.k_swap_scales[:, host] = self.k_scales[:, dev].cpu()
            self.v_swap_scales[:, host] = self.v_scales[:, dev].cpu()

    def _copy_back(self, pairs: List[tuple]) -> None:
        host = torch.tensor([h for h, _ in pairs], dtype=torch.int64)
        dev = torch.tensor([d for _, d in pairs],
                           dtype=torch.int64).to(self.device)
        self.k_pages[:, dev] = self.k_swap[:, host].to(self.device)
        self.v_pages[:, dev] = self.v_swap[:, host].to(self.device)
        if self.kv_dtype == "int8":
            self.k_scales[:, dev] = self.k_swap_scales[:, host].to(
                self.device)
            self.v_scales[:, dev] = self.v_swap_scales[:, host].to(
                self.device)

    # -- the batched attention step ------------------------------------------

    def _attend(self, q: torch.Tensor, tables: torch.Tensor,
                seq_lens: torch.Tensor) -> torch.Tensor:
        """q: [rows, H, D] -> logits [rows, vocab] over the page pool, all
        on the backend's device (tables and seq_lens int32)."""
        raise NotImplementedError

    # -- Backend protocol ----------------------------------------------------

    def step_cost(self, plan: StepPlan) -> float:
        """Real execution has no analytic model; report the last measured
        step so virtual-time consumers still see a plausible number."""
        return self._last_wall or 1e-3

    def execute(self, plan: StepPlan,
                block_tables: Optional[Dict[int, List[int]]] = None
                ) -> StepResult:
        prof = profiling.active()
        if prof is None or not prof.trace:
            return self._execute(plan, block_tables)
        self._trace = (prof, plan.step_id, plan.phase)
        try:
            return self._execute(plan, block_tables)
        finally:
            self._trace = None

    def _execute(self, plan: StepPlan,
                 block_tables: Optional[Dict[int, List[int]]]) -> StepResult:
        t0 = time.perf_counter()
        tables = block_tables if block_tables is not None \
            else plan.block_tables
        for rid in plan.preempted:
            # pages were reclaimed; also unpins a swap whose restore was
            # cancelled by a same-step recompute preemption, and discards
            # any deferred copy whose data is now dead
            self._seq_lens.pop(rid, None)
            self._swap_pinned.discard(rid)
            self._deferred.drop(rid)
        # epoch boundary: copies deferred by earlier steps land before
        # anything in THIS step touches the pools
        self._deferred.flush()
        # swap directives next, in contract order (base.Backend)
        for rid, pairs in plan.swap_outs.items():
            self._swap_pinned.add(rid)
            if self.copy_streams > 0:
                self._deferred.defer(
                    rid, lambda p=pairs: self._copy_out(p))
            else:
                self._copy_out(pairs)
        for rid, pairs in plan.restores.items():
            self._swap_pinned.discard(rid)
            if self.copy_streams > 0:
                self._deferred.defer(
                    rid, lambda p=pairs: self._copy_back(p))
            else:
                self._copy_back(pairs)

        # a speculative verify plan (docs/spec_decode.md) or a k-step
        # macro-plan (docs/multi_step.md) returns a per-step token stream
        if plan.speculative or plan.num_steps > 1:
            return self._execute_multi(plan, tables, t0)

        rows = self._prefill_rows(plan, tables)
        chunks = []
        for rid in plan.decode:
            table = tables.get(rid, [])
            tok = int(plan.new_tokens.get(rid, [0])[0])
            pos = self._seq_lens.get(rid, 0)
            chunks.append((table, pos, [tok]))
            self._track(rid, pos + 1)
            rows.append((rid, tok, pos + 1, table))
        self._write(chunks)

        tokens = self._sample_rows(rows)
        self._last_wall = time.perf_counter() - t0
        return StepResult(step_id=plan.step_id, tokens=tokens,
                          wall_s=self._last_wall)

    def _prefill_rows(self, plan: StepPlan,
                      tables: Dict[int, List[int]]) -> List[tuple]:
        """Apply the plan's prefill chunks, one scatter each; returns
        sample rows (rid, q_token, seq_len, table) for the chunks' last
        positions — the sampled token counts iff the chunk completes the
        prompt."""
        rows: List[tuple] = []
        for rid, start, n in plan.prefill:
            table = tables.get(rid, [])
            with self._span("leaf_pack"):
                toks = [int(t) for t in plan.new_tokens.get(rid, [0] * n)]
            if not toks:              # defensive: degenerate empty chunk
                self._track(rid, start)
                continue
            self._write([(table, start, toks)])
            self._track(rid, start + n)
            rows.append((rid, toks[-1], start + n, table))
        return rows

    def _sample_rows(self, rows: List[tuple]) -> Dict:
        """One batched attend + greedy sample over (key, tok, seq_len,
        table) rows, returned by key (a request id, or a (request,
        position) pair for a verify row): one host-to-device copy of the
        row data, one read of the sampled ids."""
        if not rows:
            return {}
        with self._span("leaf_pack"):
            nb_max = max(max(len(t) for _, _, _, t in rows), 1)
            host = np.full((len(rows), 2 + nb_max), -1, np.int32)
            for i, (_, tok, seq_len, table) in enumerate(rows):
                host[i, 0] = tok
                host[i, 1] = seq_len
                host[i, 2:2 + len(table)] = table
        with self._span("leaf_copy"):
            packed = torch.from_numpy(host).to(self.device)
        with self._span("leaf_launch"):
            tok = packed[:, 0].long()
            sl = packed[:, 1].contiguous()
            bt = packed[:, 2:].contiguous()
            q = (self._emb(tok) @ self._wq).view(-1, self.n_heads,
                                                 self.head_dim)
            ids = self._attend(q, bt, sl).argmax(dim=-1)
        with self._span("leaf_read"):
            nxt = ids.tolist()
        return {rid: nxt[i] for i, (rid, _, _, _) in enumerate(rows)}

    # -- multi-step macro-plans (docs/multi_step.md) --------------------

    def _execute_multi(self, plan: StepPlan,
                       tables: Dict[int, List[int]], t0: float) -> StepResult:
        """Run a macro-plan's k-step decode loop (``_decode_multi``, the
        execution seam) or verify a speculative plan's drafts
        (``_verify_multi``), and package the per-step token stream; the
        scheduler's macro consumption and ``_rollback_unused`` then reclaim
        a rejected suffix's KV."""
        tokens: Dict[int, int] = self._sample_rows(
            self._prefill_rows(plan, tables))     # per-tier macro prefill
        rids = list(plan.decode)
        tbls = {rid: tables.get(rid, []) for rid in rids}
        start = {rid: self._seq_lens.get(rid, 0) for rid in rids}
        first = {rid: int(plan.new_tokens.get(rid, [0])[0]) for rid in rids}
        budgets = {rid: plan.decode_steps.get(rid, plan.num_steps)
                   for rid in rids}
        eos = {rid: plan.eos_tokens.get(rid) for rid in rids}
        if plan.speculative:
            # plan.draft_tokens: installed worker-side by
            # repro_torch.spec.SpeculativeBackend
            drafts = {rid: list(plan.draft_tokens.get(rid, ()))
                      for rid in rids}
            steps = self._verify_multi(rids, tbls, start, first, budgets,
                                       eos, drafts)
        else:
            steps = self._decode_multi(rids, tbls, start, first, budgets,
                                       eos, plan.num_steps)
        for row in steps:
            tokens.update(row)
        for rid in rids:
            emitted = sum(1 for row in steps if rid in row)
            self._track(rid, start[rid] + emitted)
        self._last_wall = time.perf_counter() - t0
        return StepResult(step_id=plan.step_id, tokens=tokens,
                          wall_s=self._last_wall, token_steps=steps)

    # -- speculative verify (docs/spec_decode.md) ------------------------

    def _verify_multi(self, rids: List[int], tables: Dict[int, List[int]],
                      start: Dict[int, int], first: Dict[int, int],
                      budgets: Dict[int, int], eos: Dict[int, Optional[int]],
                      drafts: Dict[int, List[int]]) -> List[Dict[int, int]]:
        """Batched draft verification.  The inputs of a request are
        ``[first, d_1, .., d_{b-1}]`` (clipped to its budget b); their K/V
        is written up front in one ``_write``, then every (request,
        position i) row attends with seq_len ``start + i + 1`` in one
        ``_attend``, so row i's argmax is the model's true next token v_i
        after inputs 0..i, and one host read brings every v_i back.  Greedy
        acceptance: accept drafts while v_i == d_{i+1}; the emitted stream
        is the accepted drafts plus the first correction token, truncated
        at EOS, which is sequential greedy decode whatever the drafts
        were.  Rejected positions lie past the final tracked seq_len:
        attention masks them and the scheduler frees their blocks."""
        inputs = {rid: ([first[rid]] + [int(t) for t in drafts[rid]])
                  [:max(budgets[rid], 1)] for rid in rids}
        self._write([(tables[rid], start[rid], inputs[rid]) for rid in rids])
        verify = self._sample_rows(
            [((rid, i), tok, start[rid] + i + 1, tables[rid])
             for rid in rids for i, tok in enumerate(inputs[rid])])
        steps: List[Dict[int, int]] = []
        for rid in rids:
            ins = inputs[rid]
            for i in range(len(ins)):
                v = verify[(rid, i)]
                if len(steps) <= i:
                    steps.append({})
                steps[i][rid] = v
                if eos[rid] is not None and v == eos[rid]:
                    break                                  # stream ends here
                if i + 1 >= len(ins) or v != ins[i + 1]:
                    break                        # v is the correction token
        return steps

    def _decode_multi(self, rids: List[int], tables: Dict[int, List[int]],
                      start: Dict[int, int], first: Dict[int, int],
                      budgets: Dict[int, int], eos: Dict[int, Optional[int]],
                      k: int) -> List[Dict[int, int]]:
        """Reference k-step decode loop, one host round trip per step: each
        inner step writes the current token's K/V at the row's next
        position, attends, samples greedily and feeds the sample back.  A
        row stops after its budget or once it samples its EOS."""
        cur = dict(first)
        pos = dict(start)
        alive = {rid: True for rid in rids}
        steps: List[Dict[int, int]] = []
        for s in range(k):
            act = [rid for rid in rids if alive[rid] and s < budgets[rid]]
            if not act:
                break
            self._write([(tables[rid], pos[rid], [cur[rid]]) for rid in act])
            for rid in act:
                pos[rid] += 1
            row = self._sample_rows(
                [(rid, cur[rid], pos[rid], tables[rid]) for rid in act])
            for rid in act:
                cur[rid] = row[rid]
                if eos[rid] is not None and row[rid] == eos[rid]:
                    alive[rid] = False
            steps.append(row)
        return steps

    def release(self, req_id: int) -> None:
        """Forget a finished request's bookkeeping (pages are owned by the
        scheduler's block manager, nothing to free here)."""
        self._seq_lens.pop(req_id, None)
        self._swap_pinned.discard(req_id)
        self._deferred.drop(req_id)
