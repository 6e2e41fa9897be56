"""The operations a model of multi-head latent attention beside experts
needs (DeepSeek-V2), by part, counted from the shapes in
``drivers/gen_mla.model_config`` at 2 operations a multiply-add.

Latent attention, at its real widths: a token's four projections (``W_q``
to every head's ``Dn + Dr``, ``W_kv_a`` to ``R + Dr``, ``W_kv_b`` from
``c_kv`` to every head's ``Dn + Dv``, ``W_o``); in a prefill ``Q K^T`` at
``Dn + Dr`` and ``P V`` at ``Dv`` for every causal (query, key) pair and
head, not at the head dim B3 is padded to.  A decode step's attention is
the absorbed one: ``q_lat = q_nope W_uk`` and ``o W_uv`` per head, which
together are as many products as ``W_kv_b`` on one token, so a decode
token's projections count as a prefill token's; and for every cached
position attended, ``q_lat . c_kv + q_pe . k_pe`` and ``p c_kv`` per
head.  The feed-forward: the dense SwiGLU of the first
``first_k_dense_replace`` layers; in the others the router, the ``top_k``
experts and the shared experts, each a SwiGLU of three products.  The
logits of each sampled position.  Norms, rotary, softmax and other
elementwise work are not counted.
"""
from __future__ import annotations

from typing import Dict, Sequence

from portbench.roofline import PEAKS  # noqa: F401  (the peaks used with it)


def _widths(c: Dict):
    return (c["d_model"], c["n_heads"], c["kv_lora_rank"],
            c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"])


def mla_token_flops(c: Dict) -> float:
    """One token's four projections of latent attention, decompressed."""
    d, H, R, Dn, Dr, Dv = _widths(c)
    return 2.0 * (d * H * (Dn + Dr) + d * (R + Dr) + R * H * (Dn + Dv)
                  + H * Dv * d)


def mla_pair_flops(c: Dict) -> float:
    """``Q K^T`` and ``P V`` of one (query, key) pair over all heads."""
    _, H, _, Dn, Dr, Dv = _widths(c)
    return 2.0 * H * (Dn + Dr + Dv)


def absorbed_slot_flops(c: Dict) -> float:
    """One cached position attended by one decode token, over all heads:
    its score from ``c_kv`` and ``k_pe``, and ``p c_kv``."""
    _, H, R, _, Dr, _ = _widths(c)
    return 2.0 * H * (R + Dr + R)


def ffn_token_flops(c: Dict, dense: bool) -> float:
    """One token's feed-forward: the dense SwiGLU, or the router, ``top_k``
    experts and the shared experts."""
    d = c["d_model"]
    if dense:
        return 6.0 * d * c["d_ff"]
    return 2.0 * (d * c["n_experts"]
                  + 3 * d * (c["top_k"] * c["d_ff_expert"] + c["shared_d_ff"]))


def _ffn_layers(c: Dict) -> float:
    """One token's feed-forward over every layer."""
    k = c["first_k_dense_replace"]
    return (k * ffn_token_flops(c, True)
            + (c["n_layers"] - k) * ffn_token_flops(c, False))


def prefill_flops(c: Dict, B: int, S: int) -> float:
    """A prefill of B x S tokens from an empty cache, and the logits of
    each row's last token."""
    L = c["n_layers"]
    return (B * S * (L * mla_token_flops(c) + _ffn_layers(c))
            + L * B * S * (S + 1) // 2 * mla_pair_flops(c)
            + 2.0 * B * c["d_model"] * c["vocab_size"])


def decode_flops(c: Dict, B: int, lengths: Sequence[int]) -> float:
    """Decode steps of B rows, one a step per entry of ``lengths`` (the
    positions each row attends after that step's write), each with its
    logits."""
    L = c["n_layers"]
    per_step = B * (L * mla_token_flops(c) + _ffn_layers(c)
                    + 2.0 * c["d_model"] * c["vocab_size"])
    return (per_step * len(lengths)
            + L * B * sum(lengths) * absorbed_slot_flops(c))


def batch_flops(c: Dict, spec: Dict) -> float:
    """One batch of a ``batches`` traffic: its prefill and its decode."""
    B, S, n = spec["rows"], spec["prompt_tokens"], spec["new_tokens"]
    return prefill_flops(c, B, S) + decode_flops(
        c, B, [S + i + 1 for i in range(n)])
