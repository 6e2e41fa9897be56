"""The operations of a hybrid of Mamba-2, attention and experts
(granite-4.0-h), by layer kind, counted from the shapes in
``drivers/gen_hybrid.model_config`` at 2 operations a multiply-add.

A Mamba-2 layer: its two projections, the causal conv, and the SSD in
chunks of ``chunk`` positions: within a chunk, ``C_t . B_s`` for each
group and each causal pair (t, s) and the heads' sums of ``x_s`` weighted
by them; each chunk's own state (``x_s B_s^T`` a position) and the state's
output (``C_t h``) for each head.  A decode step runs the recurrence:
``x B^T`` into the state and ``C h`` out of it.  An attention layer: its
four projections and ``Q K^T`` and ``P V`` over the (query, key) pairs
it keeps.  Every layer's feed-forward: the router, its ``top_k`` experts
and the shared expert, each a SwiGLU of three products.  The logits of
each sampled position.  The gated norm, the conv's bias, the softmaxes
and other elementwise work are not counted.
"""
from __future__ import annotations

from typing import Dict, Sequence

from portbench.roofline import PEAKS  # noqa: F401  (the peaks used with it)


def mamba_token_flops(c: Dict) -> float:
    """One token's projections and conv through one Mamba-2 layer."""
    d, di = c["d_model"], c["ssm_heads"] * c["ssm_head_dim"]
    conv = di + 2 * c["n_groups"] * c["d_state"]
    return 2.0 * (d * (di + conv + c["ssm_heads"]) + di * d
                  + c["d_conv"] * conv)


def ssd_flops(c: Dict, B: int, S: int) -> float:
    """The chunked SSD over B sequences of S positions from zero."""
    T, n, G = c["chunk"], c["d_state"], c["n_groups"]
    nh, hd = c["ssm_heads"], c["ssm_head_dim"]
    pairs = 0
    for lo in range(0, S, T):
        t = min(T, S - lo)
        pairs += t * (t + 1) // 2
    return B * (2.0 * pairs * (G * n + nh * hd) + S * 4.0 * nh * hd * n)


def ssm_step_flops(c: Dict) -> float:
    """One token's state update and output in a decode step."""
    return 4.0 * c["ssm_heads"] * c["ssm_head_dim"] * c["d_state"]


def attn_token_flops(c: Dict) -> float:
    """One token's four attention projections."""
    d, H, KV, Dh = c["d_model"], c["n_heads"], c["n_kv_heads"], c["head_dim"]
    return 2.0 * (d * (H + 2 * KV) * Dh + H * Dh * d)


def attn_pair_flops(c: Dict) -> float:
    """``Q K^T`` and ``P V`` for one (query, key) pair over all heads."""
    return 4.0 * c["n_heads"] * c["head_dim"]


def ffn_token_flops(c: Dict) -> float:
    """One token's router, ``top_k`` experts and shared expert."""
    d = c["d_model"]
    return 2.0 * (d * c["n_experts"]
                  + 3 * d * (c["top_k"] * c["d_ff_expert"] + c["shared_d_ff"]))


def _kinds(c: Dict):
    kinds = c["layer_types"]
    return kinds.count("mamba"), kinds.count("attention")


def prefill_flops(c: Dict, B: int, S: int) -> float:
    """A prefill of B x S tokens from an empty cache, and the logits of
    each row's last token."""
    n_m, n_a = _kinds(c)
    tokens = B * S
    return (n_m * (tokens * mamba_token_flops(c) + ssd_flops(c, B, S))
            + n_a * (tokens * attn_token_flops(c)
                     + B * S * (S + 1) // 2 * attn_pair_flops(c))
            + (n_m + n_a) * tokens * ffn_token_flops(c)
            + 2.0 * B * c["d_model"] * c["vocab_size"])


def decode_flops(c: Dict, B: int, lengths: Sequence[int]) -> float:
    """Decode steps of B rows, one a step per entry of ``lengths`` (the
    positions each row attends after that step's write), each with its
    logits."""
    n_m, n_a = _kinds(c)
    per_step = B * (n_m * (mamba_token_flops(c) + ssm_step_flops(c))
                    + n_a * attn_token_flops(c)
                    + (n_m + n_a) * ffn_token_flops(c)
                    + 2.0 * c["d_model"] * c["vocab_size"])
    return (per_step * len(lengths)
            + n_a * B * sum(lengths) * attn_pair_flops(c))


def batch_flops(c: Dict, spec: Dict) -> float:
    """One batch of a ``batches`` traffic: its prefill and its decode."""
    B, S, n = spec["rows"], spec["prompt_tokens"], spec["new_tokens"]
    return prefill_flops(c, B, S) + decode_flops(
        c, B, [S + i + 1 for i in range(n)])
