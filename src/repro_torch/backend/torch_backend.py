"""Torch backend: batched decode against a paged, block-indexed cache.

The twin of ``src/repro/backend/jax_backend.py``: the shared paged
surrogate (``repro_torch.backend.surrogate``) supplies the memory system
and this class the execution engine.  Every step runs the paged decode
attention kernel (``repro_torch.kernels.paged_decode_attention``) on the
device pools, reading the scheduler's block ids directly, then the output
projection ``flat @ wo`` as a plain float32 matrix product (outside the
kernel, as in the reference).

Where the JAX backend gathers the referenced pages into a compact pool
and pads shapes to power-of-2 buckets (so that ``jit`` compiles once per
bucket), the pools here already live on the device and PyTorch runs
eagerly, so neither is needed.  The k-step macro-plan loop runs on the
device and feeds each sampled token back without a host round trip.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.backend.surrogate import PagedSurrogateBackend
from repro_torch.kernels.paged_decode_attention import paged_decode_attention


class TorchBackend(PagedSurrogateBackend):

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if self.device.type == "cuda":
            # full float32 for flat @ wo: TF32 keeps ~3 decimal digits and
            # can flip greedy argmax against the reference.  This is
            # PyTorch's default already; set here so that nothing else in
            # the process can change it unseen.
            torch.backends.cuda.matmul.allow_tf32 = False

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
        past their budget or EOS keep running masked (the loop has a fixed
        trip count): their writes go to the scratch page, their seq_len is
        0 and their emissions are dropped, which reproduces the reference
        loop's prefix-contiguous stream."""
        if self.kv_dtype == "int8":
            # int8 codes evolve by requant-on-growth, slot by slot; keep
            # the reference's per-step loop, which still attends through
            # the kernel's dequant-on-load path
            return super()._decode_multi(rids, tables, start, first,
                                         budgets, eos, k)
        rows = len(rids)
        nb_max = max(max(len(tables[rid]) for rid in rids), 1)
        host = np.full((rows, 4 + nb_max), -1, np.int32)
        for i, rid in enumerate(rids):
            host[i, :4] = (start[rid], first[rid], budgets[rid],
                           -1 if eos[rid] is None else eos[rid])
            host[i, 4:4 + len(tables[rid])] = tables[rid]
        packed = torch.from_numpy(host).to(self.device)
        sl0, tok, bud, eos_v = (packed[:, c].long() for c in range(4))
        bt = packed[:, 4:].contiguous()
        bs, H, KV, D = (self.block_size, self.n_heads, self.n_kv_heads,
                        self.head_dim)
        scratch = self.num_blocks
        alive = torch.ones(rows, dtype=torch.bool, device=self.device)
        toks, emits = [], []
        for s in range(k):
            emit = alive & (bud > s)
            pos = sl0 + s          # valid while emitting: emission is
                                   # prefix-contiguous from s = 0
            e = self._emb(tok)
            col = torch.clamp(pos // bs, max=nb_max - 1)
            page = bt.gather(1, col[:, None])[:, 0].long()
            page = torch.where(emit, page, scratch)
            slot = pos % bs
            self.k_pages[:, page, slot] = (e @ self._wk).view(
                rows, KV, D).transpose(0, 1)
            self.v_pages[:, page, slot] = (e @ self._wv).view(
                rows, KV, D).transpose(0, 1)
            q = (e @ self._wq).view(rows, H, D)
            sl = torch.where(emit, pos + 1, 0).int()
            nxt = self._attend(q, bt, sl).argmax(dim=-1)
            alive = emit & (nxt != eos_v)
            toks.append(nxt)
            emits.append(emit)
            tok = nxt
        toks_h = torch.stack(toks).tolist()
        emits_h = torch.stack(emits).tolist()
        steps: List[Dict[int, int]] = []
        for s in range(k):
            row = {rid: toks_h[s][i]
                   for i, rid in enumerate(rids) if emits_h[s][i]}
            if not row:
                break
            steps.append(row)
        return steps
