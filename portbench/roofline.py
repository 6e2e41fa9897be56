"""The chip's peaks and the work the benchmark's kernels and models need.

Peaks are NVIDIA's datasheet figures for one H100 SXM (dense, no
sparsity), which assume the card's full 700 W power limit; every result
states the card's own limit beside them.  Operations and bytes are
counted from call shapes, each input byte read once and each output byte
written once, whatever a kernel reads again.
"""
from __future__ import annotations

from typing import Dict, Sequence

PEAKS = {
    "bf16_flops": 989e12,       # tensor cores, dense
    "fp32_flops": 67e12,        # outside the tensor cores
    "hbm_bytes_per_s": 3.35e12,
    "power_limit_w": 700.0,     # the power the peaks assume
}


def bound_s(flops: float, nbytes: float, flops_peak: float) -> float:
    """The least time: the larger of operations over the compute peak and
    bytes over the memory bandwidth."""
    return max(flops / flops_peak, nbytes / PEAKS["hbm_bytes_per_s"])


def flash_call(B: int, S: int, H: int, KV: int, D: int, *,
               elt: int = 2, causal: bool = True) -> Dict[str, float]:
    """Flash attention over B sequences of S tokens: q and o [B, H, S, D],
    k and v [B, KV, S, D]; QK^T and PV at 2 operations a multiply-add over
    the kept (query, key) pairs."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return {"flops": 4.0 * D * H * B * pairs,
            "bytes": float(elt * (2 * B * S * H * D + 2 * B * S * KV * D))}


def decode_call(B: int, valid: int, H: int, KV: int, D: int, slots: int, *,
                elt: int = 2) -> Dict[str, float]:
    """Decode attention of B rows over ``valid`` cached positions each (of
    ``slots`` in the cache): q and o [B, H, D], the valid K/V, the
    lengths and the slot positions."""
    return {"flops": 4.0 * D * H * B * valid,
            "bytes": float(elt * (2 * B * H * D + 2 * B * valid * KV * D)
                           + 4 * B + 4 * slots)}


def layer_matmul_flops(cfg: Dict) -> float:
    """Operations of one token through one layer's products: the
    attention projections, the router and its ``top_k`` experts."""
    d, H, KV, Dh = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                    cfg["head_dim"])
    attn = d * (H * Dh) * 2 + d * (KV * Dh) * 2
    experts = cfg["top_k"] * 3 * d * cfg["d_ff_expert"]
    router = d * cfg["n_experts"]
    return 2.0 * (attn + experts + router)


def prefill_flops(cfg: Dict, B: int, S: int) -> float:
    """One prefill of B x S tokens: every layer's products for every
    token, causal attention, and the logits of each row's last token."""
    L = cfg["n_layers"]
    att = flash_call(B, S, cfg["n_heads"], cfg["n_kv_heads"],
                     cfg["head_dim"])["flops"]
    head = 2.0 * B * cfg["d_model"] * cfg["vocab_size"]
    return L * (B * S * layer_matmul_flops(cfg) + att) + head


def decode_flops(cfg: Dict, B: int, lengths: Sequence[int]) -> float:
    """Decode steps of B rows, one step per entry of ``lengths`` (the
    positions each row attends after that step's write)."""
    L = cfg["n_layers"]
    per_step = (L * B * layer_matmul_flops(cfg)
                + 2.0 * B * cfg["d_model"] * cfg["vocab_size"])
    att = sum(L * 4.0 * cfg["head_dim"] * cfg["n_heads"] * B * n
              for n in lengths)
    return per_step * len(lengths) + att
