"""Torch backend: batched decode against a paged, block-indexed cache.

The twin of ``src/repro/backend/jax_backend.py``: the shared paged
surrogate (``repro_torch.backend.surrogate``) supplies the memory system
and this class the execution engine.  Every step runs the paged decode
attention kernel (``repro_torch.kernels.paged_decode_attention``) on the
device pools, reading the scheduler's block ids directly, then the output
projection ``flat @ wo`` as a plain float32 matrix product (outside the
kernel, as in the reference).

The k-step macro-plan loop (``_decode_multi``) is the twin of the
reference's jitted ``lax.scan``: its inputs are padded to power-of-2
buckets, rows to ``rows_p`` and the table width to ``nb_p``, as the
reference pads them, and copied into the bucket's static buffers; on the
card one step of the loop is captured as a CUDA graph per ``(rows_p,
nb_p)`` and the pool's storage (``kernels._graph``) and replayed k times,
with one host read of the sampled tokens after the k steps.  The step
writes its sampled column at a device index into an output as wide as the
largest k the scheduler sends (``max_steps``), so a plan whose k shrinks
at the tail of a request replays its bucket's graph.  CPU
tensors run the same step eagerly on the same padded buffers.  Where the
reference gathers the referenced pages into a compact pool (and so adds
``pool_p`` to its key), the pools here already live on the device and the
loop reads them in place, through the scheduler's block ids.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.backend.surrogate import PagedSurrogateBackend
from repro_torch.kernels._graph import GraphCache, storage_key
from repro_torch.kernels.paged_decode_attention import paged_decode_attention


def _pow2_at_least(n: int, lo: int) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def _n_buckets(n: int) -> int:
    """How many of the powers of 2 that ``_pow2_at_least(m, 2)`` gives
    for m = 1..n."""
    return max(1, (n - 1).bit_length())


class _LoopState:
    """The static buffers of one ``(rows_p, nb_p)`` bucket: the call's
    inputs as one int32 buffer (block tables [rows_p, nb_p], then start
    positions, first tokens, budgets and EOS ids, [rows_p] each), the
    carried token, the alive mask, the step index, and each step's sampled
    token and emission flag ([k, 2, rows_p] int32, k the widest call the
    bucket takes)."""

    def __init__(self, rows_p: int, nb_p: int, k: int, device):
        i32 = dict(dtype=torch.int32, device=device)
        self.packed = torch.empty(rows_p * (nb_p + 4), **i32)
        self.bt = self.packed[:rows_p * nb_p].view(rows_p, nb_p)
        self.sl0, self.tok0, self.bud, self.eos = \
            self.packed[rows_p * nb_p:].view(4, rows_p)
        self.tok = torch.empty(rows_p, dtype=torch.int64, device=device)
        self.alive = torch.empty(rows_p, dtype=torch.bool, device=device)
        self.s = torch.empty(1, dtype=torch.int64, device=device)
        self.out = torch.empty((k, 2, rows_p), **i32)


class TorchBackend(PagedSurrogateBackend):

    def __init__(self, *, max_steps: int = 1, **kwargs):
        """``max_steps``: the largest k a macro-plan sends to
        ``_decode_multi`` (the scheduler's ``max_steps_per_dispatch``, or
        ``speculative_k`` for a draft); a wider call still runs, in a
        bucket of its own width."""
        super().__init__(**kwargs)
        self.max_steps = max_steps
        self.graphs: Optional[GraphCache] = None
        if self.device.type == "cuda":
            # full float32 for flat @ wo: TF32 keeps ~3 decimal digits and
            # can flip greedy argmax against the reference.  This is
            # PyTorch's default already; set here so that nothing else in
            # the process can change it unseen.
            torch.backends.cuda.matmul.allow_tf32 = False
            # every bucket the pool can make stays captured, as the
            # reference's _scan_cache keeps every compiled bucket: a
            # decoding row holds at least one page and a table at most
            # num_blocks, so rows_p and nb_p each take at most
            # _n_buckets(num_blocks) values (11 each for the serve runs'
            # 1,536 pages), and the pool's storage is the backend's own
            self.graphs = GraphCache(
                capacity=_n_buckets(self.num_blocks) ** 2)

    @property
    def kernel_launches(self) -> int:
        """Launches of the paged attention kernel in this process."""
        return paged_decode_attention.launches

    def _attend(self, q: torch.Tensor, tables: torch.Tensor,
                seq_lens: torch.Tensor) -> torch.Tensor:
        out = paged_decode_attention(q, self.k_pages, self.v_pages, tables,
                                     seq_lens, k_scales=self.k_scales,
                                     v_scales=self.v_scales)
        return out.reshape(out.shape[0], -1) @ self._wo

    # -- multi-step decode on the device (docs/multi_step.md) -----------

    def _decode_multi(self, rids: List[int], tables: Dict[int, List[int]],
                      start: Dict[int, int], first: Dict[int, int],
                      budgets: Dict[int, int], eos: Dict[int, Optional[int]],
                      k: int) -> List[Dict[int, int]]:
        """The k-step decode loop on the device: each inner step embeds
        the carried token, writes its K/V, attends, samples greedily and
        feeds the sample back, with one host read after the k steps.  Rows
        past their budget or EOS, and the padding rows (budget 0), keep
        running masked (the loop has a fixed trip count): their writes go
        to the scratch page, their seq_len is 0 and their emissions are
        dropped, which reproduces the reference loop's prefix-contiguous
        stream.  On the card the step is a replayed CUDA graph."""
        if self.kv_dtype == "int8":
            # int8 codes evolve by requant-on-growth, slot by slot; keep
            # the reference's per-step loop, which still attends through
            # the kernel's dequant-on-load path
            return super()._decode_multi(rids, tables, start, first,
                                         budgets, eos, k)
        with self._span("leaf_pack"):
            rows = len(rids)
            rows_p = _pow2_at_least(rows, 2)
            nb_p = _pow2_at_least(
                max(max(len(tables[rid]) for rid in rids), 1), 2)
            host = np.full(rows_p * (nb_p + 4), -1, np.int32)
            bt = host[:rows_p * nb_p].reshape(rows_p, nb_p)
            meta = host[rows_p * nb_p:].reshape(4, rows_p)
            meta[:3] = 0          # padding rows: start 0, token 0, budget 0
            for i, rid in enumerate(rids):
                bt[i, :len(tables[rid])] = tables[rid]
                meta[:, i] = (start[rid], first[rid], budgets[rid],
                              -1 if eos[rid] is None else eos[rid])
        width = max(self.max_steps, k)
        if self.graphs is None:
            entry, st = None, _LoopState(rows_p, nb_p, width, self.device)
        else:
            entry = self.graphs.entry(
                (rows_p, nb_p, width, storage_key(
                    self.k_pages, self.v_pages, self._embed, self._wq,
                    self._wk, self._wv, self._wo)),
                lambda: _LoopState(rows_p, nb_p, width, self.device))
            st = entry.state
        with self._span("leaf_copy"):
            st.packed.copy_(torch.from_numpy(host))
        with self._span("leaf_launch"):
            st.tok.copy_(st.tok0)
            st.alive.fill_(True)
            st.s.zero_()
            if entry is None:
                for _ in range(k):
                    self._loop_step(st)
            else:
                self.graphs.run(entry, lambda: self._loop_step(st), k)
        with self._span("leaf_read"):
            out = st.out[:k].tolist()         # [k][toks, emits][rows_p]
        steps: List[Dict[int, int]] = []
        for s in range(k):
            row = {rid: out[s][0][i]
                   for i, rid in enumerate(rids) if out[s][1][i]}
            if not row:
                break
            steps.append(row)
        return steps

    def _loop_step(self, st: _LoopState) -> None:
        """Step ``st.s`` of the loop, on the bucket's buffers alone (the
        body the reference's scan runs)."""
        rows_p, nb_p = st.bt.shape
        bs, H, KV, D = (self.block_size, self.n_heads, self.n_kv_heads,
                        self.head_dim)
        emit = st.alive & (st.bud > st.s)
        pos = st.sl0 + st.s     # valid while emitting: emission is
                                # prefix-contiguous from s = 0
        e = self._emb(st.tok)
        col = torch.clamp(pos // bs, max=nb_p - 1)
        page = st.bt.gather(1, col[:, None])[:, 0].long()
        page = torch.where(emit, page, self.num_blocks)   # the scratch page
        slot = pos % bs
        self.k_pages[:, page, slot] = (e @ self._wk).view(
            rows_p, KV, D).transpose(0, 1)
        self.v_pages[:, page, slot] = (e @ self._wv).view(
            rows_p, KV, D).transpose(0, 1)
        q = (e @ self._wq).view(rows_p, H, D)
        sl = torch.where(emit, pos + 1, 0).int()
        nxt = self._attend(q, st.bt, sl).argmax(dim=-1)
        st.alive.copy_(emit & (nxt != st.eos))
        st.out.index_copy_(0, st.s, torch.stack((nxt.int(),
                                                 emit.int()))[None])
        st.tok.copy_(nxt)
        st.s.add_(1)
