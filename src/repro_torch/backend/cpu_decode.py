"""CPU decode backend: the paged surrogate with a plain attention on the CPU.

The twin of ``src/repro/backend/cpu_decode.py``, the CPU-class physical
backend for split-phase serving (arXiv:2504.11750, arXiv:2603.12831): the
same page pools, swap tier and greedy sampling as ``TorchBackend`` (the
shared ``PagedSurrogateBackend`` supplies all of it), but its pools live in
host memory and ``_attend`` is a gather-then-softmax in float32 on the CPU
instead of the paged decode attention kernel.  It never touches CUDA.  It
mirrors ``paged_decode_attention_reference`` term for term, so its argmax
samples match the kernel's and a request's decode can move between the two
backends mid-flight (``HybridBackend`` relies on exactly this).

Standalone it is a complete backend (it prefills too: a slow-class device,
not a decode-only shard); under ``HybridBackend`` it receives the decode
sub-plan, and under ``SpeculativeBackend`` it drafts.
"""
from __future__ import annotations

import torch

from repro_torch.backend.surrogate import PagedSurrogateBackend


class CpuDecodeBackend(PagedSurrogateBackend):

    def __init__(self, **kwargs):
        device = kwargs.pop("device", "cpu")
        if torch.device(device).type != "cpu":
            raise ValueError(f"CpuDecodeBackend runs on the CPU, got "
                             f"device={device!r}")
        super().__init__(device="cpu", **kwargs)

    def _attend(self, q: torch.Tensor, tables: torch.Tensor,
                seq_lens: torch.Tensor) -> torch.Tensor:
        """q: [rows, H, D] -> logits [rows, vocab]: gather each row's pages
        (dequantized if int8), mask slots past seq_len and under -1 entries
        at -1e30, softmax in float32, multiply by V, project through the
        output head."""
        rows, H, D = q.shape
        KV = self.n_kv_heads
        nb = max(tables.shape[1], 1)
        blk = self.block_size
        pages = tables.long().clamp(0, self.num_blocks - 1)     # [rows, nb]
        k, v = self._gather_pages(pages)          # [KV, rows, nb, blk, D]
        k = k.movedim(1, 0).reshape(rows, KV, nb * blk, D)
        v = v.movedim(1, 0).reshape(rows, KV, nb * blk, D)
        s = torch.einsum("bgrd,bgsd->bgrs", q.reshape(rows, KV, H // KV, D),
                         k) / (D ** 0.5)
        pos = torch.arange(nb * blk)[None, :]
        valid = (pos < seq_lens[:, None]) & torch.repeat_interleave(
            tables >= 0, blk, dim=1)
        s = torch.where(valid[:, None, None, :], s,
                        torch.tensor(-1e30, dtype=s.dtype))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        out = torch.einsum("bgrs,bgsd->bgrd",
                           p / torch.where(l == 0, torch.ones_like(l), l), v)
        return out.reshape(rows, H * D) @ self._wo
