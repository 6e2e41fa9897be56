"""Config system: architecture hyperparameters + input-shape cells.

The port's copy of ``src/repro/configs/base.py``, with the same dataclasses,
cells and numbers.  Two things differ: ``ModelConfig.param_dtype`` returns
a ``torch.dtype``, and ``input_specs`` returns tensors on the ``meta``
device (shape and dtype, no storage) in place of ``ShapeDtypeStruct``s.
``tiny_config`` lives where the reference has it, in
``repro_torch.launch.train``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    # Experts are padded to a multiple of the EP axis size at shard time;
    # router logits for padding experts are masked to -inf.
    router_jitter: float = 0.0
    capacity_factor: float = 1.25
    # port-only, each at the JAX package's behaviour by default: the top-k
    # gates over their sum (off: the router's probabilities as they are,
    # DeepSeek-V2's ``norm_topk_prob`` false), and the shared experts
    # behind a sigmoid gate (qwen2-moe; off: added as they are, DeepSeek-V2
    # and granite-4.0-h)
    renormalize: bool = True
    shared_gated: bool = True


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    version: int               # 1 = Mamba-1 selective scan, 2 = Mamba-2 / SSD
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64         # Mamba-2 only
    dt_rank: Optional[int] = None  # Mamba-1 only; default ceil(d_model/16)
    chunk: int = 128           # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int
    n_encoder_ctx: int         # e.g. Whisper: 1500 audio frames post-conv
    cross_attention: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None          # default d_model // n_heads
    # --- attention details -------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # window size for local layers
    local_global_ratio: Optional[Tuple[int, int]] = None  # e.g. (5, 1) gemma3
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    norm: str = "rmsnorm"                 # rmsnorm | layernorm | nonparametric_ln
    mlp: str = "swiglu"                   # swiglu | gelu | geglu
    tie_embeddings: bool = False
    # --- optional sub-configs ----------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None
    # hybrid (zamba2-style): one shared attention block applied every
    # ``hybrid_period`` ssm layers, reusing the same parameters.
    hybrid_period: Optional[int] = None
    # --- numerics -----------------------------------------------------------
    dtype: str = "bfloat16"
    # pad vocab to a multiple of this for TP sharding of embed/logits
    vocab_pad_multiple: int = 128
    max_position: int = 1 << 20

    # -- derived -------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_decoder_only(self) -> bool:
        return self.encdec is None

    def layer_windows(self) -> Sequence[Optional[int]]:
        """Per-layer sliding-window sizes (None = full/global attention)."""
        if self.local_global_ratio is None:
            return [self.sliding_window] * self.n_layers
        local, glob = self.local_global_ratio
        period = local + glob
        out = []
        for i in range(self.n_layers):
            # gemma3 pattern: 5 local layers then 1 global layer.
            out.append(self.sliding_window if (i % period) < local else None)
        return out

    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced copy for smoke tests (same family, tiny dims)."""
        return dataclasses.replace(self, **overrides)


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeCell("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeCell("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeCell("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeCell("long_500k", "decode", 524_288, 1)

ALL_CELLS = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
CELLS_BY_NAME = {c.name: c for c in ALL_CELLS}

# Archs allowed to run long_500k (sub-quadratic path exists).  Pure
# full-attention archs skip it (see DESIGN.md §4).
LONG_CONTEXT_ARCHS = frozenset({"falcon-mamba-7b", "zamba2-1.2b", "gemma3-12b"})


def cell_applicable(config: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """Whether an (arch, cell) pair is runnable; returns (ok, reason)."""
    if cell.name == "long_500k" and config.name not in LONG_CONTEXT_ARCHS:
        return False, "pure full-attention arch: no sub-quadratic path at 512k (DESIGN.md §4)"
    return True, ""


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shape and dtype, no storage)
# ---------------------------------------------------------------------------


def _sd(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(config: ModelConfig, cell: ShapeCell) -> dict:
    """Model inputs for one shape cell as meta tensors.

    train:   {tokens, targets}                    -> train step
    prefill: {tokens}                             -> prefill
    decode:  {tokens[B,1], cache_len}             -> decode_step (+ cache built
             separately with ``cache_specs``)
    Modality frontends (audio/vlm) are stubs: precomputed frame/patch
    embeddings arrive as inputs.
    """
    B, S = cell.global_batch, cell.seq_len
    specs: dict = {}
    if cell.kind == "train":
        specs["tokens"] = _sd((B, S), torch.int32)
        specs["targets"] = _sd((B, S), torch.int32)
    elif cell.kind == "prefill":
        specs["tokens"] = _sd((B, S), torch.int32)
    else:  # decode: one new token against a cache of S
        specs["tokens"] = _sd((B, 1), torch.int32)
        specs["cache_len"] = _sd((), torch.int32)

    if (config.family == "audio" and config.encdec is not None
            and cell.kind != "decode"):
        # Whisper: conv frontend stubbed; encoder sees precomputed frame
        # embeds.  Decode reads cross-attention K/V from the cache instead.
        specs["frames"] = _sd(
            (B, config.encdec.n_encoder_ctx, config.d_model),
            config.param_dtype())
    if config.family == "vlm":
        # Qwen2-VL: M-RoPE position ids (3, B, S) — t/h/w sections. Patch
        # embeddings are precomputed and merged upstream (stub), so the
        # backbone consumes token ids + positions.
        pos_len = 1 if cell.kind == "decode" else S
        specs["mrope_positions"] = _sd((3, B, pos_len), torch.int32)
    return specs


# ---------------------------------------------------------------------------
# Port-only architectures (no twin in the JAX package)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mamba2Config(SSMConfig):
    """Mamba-2 as published (Dao & Gu 2024; granite-4.0-h): one input
    projection to ``[z, x || B || C, dt]``, a causal conv with bias over all
    of ``x || B || C``, the SSD with ``n_groups`` groups of B and C shared
    by the heads, and ``y * silu(z)`` through a gated RMSNorm, whose eps
    is the model's (``HybridMoEConfig.norm_eps``).  zamba2's block (a
    plain ``SSMConfig``, version 2) is the JAX package's simplification
    of it."""
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class HybridMoEConfig(ModelConfig):
    """A stack of Mamba-2 and attention layers, each followed by the
    experts and an ungated shared expert (granite-4.0-h, ``family``
    ``"hybrid_moe"``).  ``layer_types`` names each layer's mixer
    (``"mamba"`` or ``"attention"``); attention has no positions (NoPE)
    and scales its scores by ``attention_multiplier``; the embeddings are
    scaled by ``embedding_multiplier``, each residual branch by
    ``residual_multiplier``, and the logits divided by
    ``logits_scaling``; every RMSNorm takes ``norm_eps``."""
    layer_types: Tuple[str, ...] = ()
    shared_d_ff: int = 0
    embedding_multiplier: float = 1.0
    attention_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    norm_eps: float = 1e-5

    def period(self) -> int:
        """The shortest repeat of ``layer_types`` that tiles it whole."""
        n = len(self.layer_types)
        return next(p for p in range(1, n + 1) if n % p == 0 and
                    self.layer_types == self.layer_types[:p] * (n // p))


@dataclasses.dataclass(frozen=True)
class YarnScaling:
    """YaRN's stretch of the rotary frequencies (Peng et al. 2023, as
    DeepSeek-V2 applies it): the frequencies whose wavelength fits
    ``original_max_position`` more than ``beta_fast`` times keep their
    value, those that fit fewer than ``beta_slow`` times are divided by
    ``factor``, and a linear ramp over the dimensions between them blends
    the two; cos and sin are scaled by ``mscale(factor, mscale) /
    mscale(factor, mscale_all_dim)``, and the softmax's scale by
    ``mscale(factor, mscale_all_dim)`` squared
    (``models.layers.yarn_mscale``)."""
    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig(ModelConfig):
    """DeepSeek-V2's stack (``family`` ``"mla_moe"``): every layer's
    attention is multi-head latent attention (``models.mla``): per token
    one latent ``c_kv`` of ``kv_lora_rank`` values (RMS-normed) and one
    rotary key ``k_pe`` of ``qk_rope_head_dim`` shared by the heads are
    cached; each head's query is ``qk_nope_head_dim`` plain and
    ``qk_rope_head_dim`` rotary values (no compression of q), its key's
    plain part and its value (``v_head_dim``) are decompressed from
    ``c_kv``.  The rotary runs under ``rope_scaling`` (YaRN) where given.
    The first ``first_k_dense_replace`` layers have a dense SwiGLU of
    ``d_ff``, the others the experts of ``moe`` with its shared experts;
    every RMSNorm takes ``norm_eps``."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_scaling: Optional[YarnScaling] = None
    first_k_dense_replace: int = 0
    norm_eps: float = 1e-6
