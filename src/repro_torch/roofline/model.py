"""Three-term roofline model over dry-run records, on the H100: the port
of ``src/repro/roofline/model.py``.

  compute_s    = FLOPs_per_device / peak_flops
  memory_s     = bytes_per_device / hbm_bw
  collective_s = collective_operand_bytes_per_device / link_bw

The dry-run traces one rank's program of the step (``repro_torch.launch.
dryrun``), so its counts are per device and dividing by one card's peaks
is the same as the global form total / (cards x peak).  The analytic part
(``param_count``, ``model_bytes_per_device``, ``model_flops``) is the
reference's, term for term; only the hardware differs: one
``HardwareSpec``, the H100 80GB HBM3 (SXM), from NVIDIA's datasheet, not a
measurement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeCell


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # bf16 FLOP/s per chip
    hbm_bw: float              # bytes/s per chip
    link_bw: float             # bytes/s per ICI link
    hbm_bytes: float           # per chip


# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM column
# (https://www.nvidia.com/en-us/data-center/h100/): 989 TFLOPS dense BF16
# (the 1,979 quoted is with sparsity), 3.35 TB/s HBM3, 80 GB, NVLink 4 at
# 900 GB/s in both directions together (450e9 B/s each way).
H100_SXM = HardwareSpec(
    name="h100-sxm-80gb",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    hbm_bytes=80e9,
)


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: float, hw: HardwareSpec = H100_SXM
                   ) -> Dict[str, float]:
    compute_s = flops / hw.peak_flops
    memory_s = bytes_accessed / hw.hbm_bw
    collective_s = coll_bytes / hw.link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["dominant"] = dom
    terms["bound_s"] = bound
    # roofline fraction: useful-compute share of the bounding term
    terms["roofline_fraction"] = compute_s / bound if bound > 0 else 0.0
    return terms


# ---------------------------------------------------------------------------
# analytic model FLOPs (6·N·D dense / 6·N_active·D MoE), cross-check for
# remat/redundancy waste in the compiled HLO
# ---------------------------------------------------------------------------


def param_count(cfg: ModelConfig, active_only: bool = False) -> float:
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    n = V * d                                    # embeddings
    if not cfg.tie_embeddings:
        n += V * d
    if cfg.family == "ssm":
        di = cfg.ssm.expand * d
        per = (2 * d * di              # in proj
               + cfg.ssm.d_conv * di   # conv
               + di * d                # out proj
               + di * (cfg.ssm.dt_rank or d // 16)
               + (cfg.ssm.dt_rank or d // 16) * di
               + 2 * di * cfg.ssm.d_state)
        return n + L * per
    dh = cfg.head_dim
    attn = d * cfg.n_heads * dh * 2 + d * cfg.n_kv_heads * dh * 2
    if cfg.family == "hybrid":
        di = cfg.ssm.expand * d
        per_ssm = 2 * d * di + cfg.ssm.d_conv * di + di * d + 2 * cfg.ssm.d_state * d
        shared = attn + 3 * d * cfg.d_ff
        period = cfg.hybrid_period or 6
        n_shared_calls = -(-L // period)
        return n + L * per_ssm + shared  # shared params counted once
    if cfg.moe is not None:
        e = cfg.moe.top_k if active_only else cfg.moe.n_experts
        ff = 3 * d * cfg.moe.d_ff_expert * e
        if cfg.moe.n_shared_experts:
            ff += 3 * d * cfg.moe.d_ff_expert * cfg.moe.n_shared_experts
        per = attn + ff + d * cfg.moe.n_experts
        return n + L * per
    mults = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    per = attn + mults * d * cfg.d_ff
    if cfg.encdec is not None:
        enc = attn + mults * d * cfg.d_ff
        cross = attn
        return n + L * (per + cross) + cfg.encdec.n_encoder_layers * enc
    return n + L * per


def model_bytes_per_device(cfg: ModelConfig, cell: ShapeCell, *,
                           tp: int = 16, dp: int = 16,
                           n_micro: int = 1) -> float:
    """Analytic minimum HBM traffic per device per step (the card's
    estimate; the reference's formula).

    The dry-run's traced bytes count every op's operands and results, op
    by op — a large upper bound against fused kernels (B3/B4 keep their
    working sets in shared memory and registers).  This lower-bound model
    counts the traffic a fused program must pay:
      params (read fwd+bwd per microbatch, + optimizer RW),
      layer-boundary activations (save + read + recompute),
      KV-cache reads/writes.
    The true value lies between this and the traced number.
    """
    P_dev = 2.0 * param_count(cfg) / tp                   # bf16 shard
    B_loc = max(cell.global_batch // dp, 1)
    d, L = cfg.d_model, cfg.n_layers
    if cell.kind == "train":
        opt = (param_count(cfg) / (tp * dp)) * 4 * 8      # master+m+v+grad RW
        params_traffic = P_dev * 2 * 2 * n_micro + opt
        act = (L * (B_loc / max(n_micro, 1)) * cell.seq_len * d * 2
               / tp) * 3 * n_micro                        # SP-sharded stack
        return params_traffic + act
    if cell.kind == "prefill":
        act = L * B_loc * cell.seq_len * d * 2 * 4 / tp
        kv = _kv_bytes(cfg, cell, tp, dp)
        return P_dev + act + kv
    # decode: weights + full KV read + tiny write
    return P_dev + _kv_bytes(cfg, cell, tp, dp)


def _kv_bytes(cfg: ModelConfig, cell: ShapeCell, tp: int, dp: int) -> float:
    if cfg.n_heads == 0:
        di = cfg.ssm.expand * cfg.d_model
        return (cell.global_batch / dp) * (di * cfg.ssm.d_state * 4
                                           ) * cfg.n_layers / tp
    B_loc = max(cell.global_batch // dp, 1)
    per_layer = []
    windows = cfg.layer_windows()
    for w in windows:
        s = min(cell.seq_len, w) if w else cell.seq_len
        per_layer.append(B_loc * s * cfg.n_kv_heads * cfg.head_dim * 2 * 2)
    return sum(per_layer) / min(tp, max(cfg.n_kv_heads, 1))


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """Useful model FLOPs for one step of this cell (global, all chips)."""
    n_active = param_count(cfg, active_only=True)
    # subtract embedding gather (not matmul FLOPs) but keep unembed
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    mult = 6 if cell.kind == "train" else 2
    flops = mult * n_active * tokens
    # attention score/value FLOPs (causal half) — non-negligible at 32k+
    if cfg.n_heads:
        S = cell.seq_len
        kv_len = S
        q_len = S if cell.kind != "decode" else 1
        causal_frac = 0.5 if cell.kind != "decode" else 1.0
        att = (2 * cfg.n_heads * cfg.head_dim * q_len * kv_len
               * causal_frac * 2 * cell.global_batch)  # qk + av
        flops += att * cfg.n_layers * (3 if cell.kind == "train" else 1)
    return flops
