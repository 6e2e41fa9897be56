"""The model stack for all ten architectures: the port of
``src/repro/models/model.py``.

A model is a list of *stages*; a stage repeats ``n_periods`` identical
*periods*; a period is a short static list of layer templates
(``LayerSpec``).  The port builds the same plan (``build_plan``) and keeps
the reference's parameter and cache trees, with one ``nn.ModuleList`` of
periods per stage in place of the reference's stacked period axis:

  dense (granite/olmo/qwen2) and vlm (qwen2-vl):  1 stage, period = [attn]
  gemma3 (5 local : 1 global):                   1 stage, period = [local x5, global]
  falcon-mamba:                                  1 stage, period = [ssm]
  zamba2 (shared attn every 6):                  ``hybrid``: 6 periods of
                                                 [shared_attn, ssm x6];
                                                 ``hybrid_tail``: 1 period of
                                                 [shared_attn, ssm x2]
  whisper:                                       ``encoder``: [bidir attn] x12;
                                                 ``decoder``: [self + cross
                                                 attn] x12
  moe archs:                                     1 stage, period = [attn(moe)]
  granite-4.0-h (port-only, ``hybrid_moe``):    1 stage, period = the
                                                 repeat of ``layer_types``
                                                 ([ssm x5, attn, ssm x4])
  DeepSeek-V2 (port-only, ``mla_moe``):         ``mla_dense``: [mla(mlp)] x
                                                 ``first_k_dense_replace``;
                                                 ``mla_moe``: [mla(moe)] x
                                                 the rest

zamba2's shared attention block is one set of weights at the top level
(``shared_block``), looked up by every period, with a K/V cache of its
own per period.  Whisper's encoder (``Model._encode``) runs over the
frames given as ``extras["frames"]`` [B, T, d] (the conv frontend is a
stub, as in the reference) with sinusoidal positions; the decoder adds
sinusoidal positions to its token embeddings, and each decoder layer
attends the encoder's output through its ``cross`` attention, whose K/V
prefill projects once and stores as ``xk``/``xv`` in the layer's cache
entry.  A moe layer runs ``models.moe`` in place of its MLP, with its
shared experts where the configuration has them, behind a sigmoid gate
(qwen2-moe) or added as they are (``MoEConfig.shared_gated`` off:
DeepSeek-V2, granite-4.0-h; ``shared_experts``); ``backbone`` returns its aux
loss summed over the layers, which ``Model.loss_fn`` weighs into the
training loss and ``prefill`` and decoding drop, as the reference's do.

granite-4.0-h's layers (``HybridMoELayer``, port-only: the JAX package
has no such model) run the published Mamba-2 (``ssm.Mamba2``) or GQA
attention without positions (NoPE), each followed by the experts and an
ungated shared expert; the model scales its embeddings, residual branches
and logits by the configuration's multipliers (``HybridMoEConfig``).  In
a prefill their mixers and feed-forwards are timed on the device when
``profiling.start_model_spans`` has turned the model's spans on.

DeepSeek-V2's layers (``MLAConfig``, port-only) are ``AttnLayer``s whose
attention is multi-head latent attention (``models.mla``: decompressed
prefill on B3, absorbed decode over the latent cache), rotated under YaRN
where the configuration stretches the rotary; their norms take the
configuration's eps.  In a prefill, spans time each layer's latent
attention (``mla_mixer``) and every ``AttnLayer``'s MLP or experts
(``ffn``).

Entry points: ``Model.loss_fn`` (training: ``backbone`` -> ``chunked_ce``,
the cross-entropy in sequence chunks under ``torch.utils.checkpoint``;
``remat`` runs each period under it too), ``Model.forward``,
``Model.prefill``, ``Model.decode_step``, ``Model.decode_multi`` and
``cache_specs``, with the reference's shapes.
The cache is ``{stage: {"layer{i}": entry}}`` over the decoder stages
(not whisper's encoder), with a leading period axis: an attention entry
is ``{"k", "v"}``, ``[n_periods, B, Sc, KVs, Dh]`` (window layers hold a
ring of ``Sc = window`` slots once the sequence is longer; whisper's
decoder layers add ``"xk", "xv"``, ``[n_periods, B, T, KVs, Dh]``), a
latent attention entry ``{"ckv": [n_periods, B, Sc, R], "kpe":
[n_periods, B, Sc, Dr]}``, an ssm entry ``{"conv": [n_periods, B, K-1,
di]`` in the config dtype, ``"ssm": [n_periods, B, di, n]`` (Mamba-1) or
``[n_periods, B, nh, hd, n]`` (Mamba-2) in float32``}``.  Unlike the reference, ``decode_step``
writes the new token's K/V and the new ssm states into the cache it is
given, in place, and returns that cache: a functional update would copy
the whole cache every token, and a cache that stays put can be captured
in a CUDA graph, as ``decode_multi`` captures its step on the card.  What
all layers of a call share (the rotary cos/sin per layer template, a
decode step's lengths, write slots and slot positions) is computed once
per call, not once per layer.

Attention and the Mamba-1 scan run through ``repro_torch.kernels.ops``:
the CUDA kernels (B3 at prefill and in training, whisper's encoder
included, B2 at decode, whisper's cross-attention included, B4 in every
Mamba-1 layer) for tensors on the card, their plain versions on the CPU;
when a gradient is required, B3 and B4 run through their autograd
Functions, whose backward passes are kernels too.  Projections,
MLPs, the experts, cross-attention at prefill, Mamba-2's SSD and logits
are ``torch`` ops and matrix products, as the reference leaves them to
XLA.  Weights are drawn from an explicit
``torch.Generator`` on an explicit device, by default the card (raising
without one); ``repro_torch.models.convert`` carries the reference's
weights across instead.

Under a mesh (``repro_torch.dist.sharding.use_mesh``) the head layout and
the padded experts follow its ``tp``, as the reference's do, and
``param_axes`` / ``param_shardings`` and ``cache_axes`` /
``cache_shardings`` give the reference's spec trees (keyed by the
reference's paths, a stage's leaves with their leading period axis).
``place_params`` lays the model's parameters out by them, as DTensors
(a period's parameter takes its stage leaf's spec without the period
entry), and the entry points then run on DTensors: the reference's shard
sites (``embed_lookup``'s vocab-sharded gather, ``lm_logits``, the
residual stream after each attention layer and at the embeddings) are
``shard`` calls, the kernels run on each rank's shards
(``kernels.ops``), and plain tensors made inside a call (positions,
rotary angles, masks) count as replicated.  Every layer, the ssm layers
and decode steps too, ends with the residual stream on ``("dp", "sp",
None)``: DTensor keeps a row-parallel product's sum pending until an op
needs it, and left pending it can make the next layer's product gather
its weights (where XLA, laying out the whole step, takes the sum).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import profiling
from repro_torch.configs.base import HybridMoEConfig, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (
    coordinate,
    current as mesh_ctx,
    is_dtensor,
    place,
    pmax,
    psum,
    replicated_inputs,
    shard,
    shard_index,
    shard_map,
    spec_for,
    spec_of,
    tree_map,
)
from repro_torch.kernels._graph import GraphCache, storage_key
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (
    Attention,
    HeadLayout,
    attn_param_axes,
    cross_attention,
    decode_attention,
    flash_attention,
    head_layout,
    write_slot,
)
from repro_torch.models.layers import (
    MLP,
    Norm,
    dense_init,
    embed_init,
    mrope_cos_sin,
    rope_cos_sin,
    rotate,
    sinusoid_embed,
    sinusoid_positions,
    yarn_cos_sin,
)

# ---------------------------------------------------------------------------
# stack plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                       # attn | mla | ssm | shared_attn | enc_attn | dec_attn
    window: Optional[int] = None    # sliding-window size (None = full)
    rope_theta: float = 10_000.0
    causal: bool = True
    cross: bool = False             # whisper decoder cross-attention
    mlp: Optional[str] = None       # None = no MLP (mamba blocks)
    moe: bool = False
    use_rope: bool = True           # whisper uses absolute positions instead
    use_mrope: bool = False


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    specs: Tuple[LayerSpec, ...]    # layer templates within one period
    n_periods: int
    encoder: bool = False           # whisper encoder (consumes frames)


def build_plan(cfg: ModelConfig) -> List[Stage]:
    """The reference's plan, family by family."""
    if cfg.family == "ssm":
        return [Stage("ssm", (LayerSpec(kind="ssm"),), cfg.n_layers)]
    if cfg.family == "hybrid":
        period = cfg.hybrid_period or 6
        full, tail = divmod(cfg.n_layers, period)
        shared = LayerSpec(kind="shared_attn", rope_theta=cfg.rope_theta,
                           mlp=cfg.mlp)
        ssm = LayerSpec(kind="ssm")
        stages = [Stage("hybrid", (shared,) + (ssm,) * period, full)]
        if tail:
            stages.append(Stage("hybrid_tail", (shared,) + (ssm,) * tail, 1))
        return stages
    if cfg.family == "hybrid_moe":
        if len(cfg.layer_types) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(cfg.layer_types)} layer "
                             f"types for {cfg.n_layers} layers")
        kinds = {"mamba": LayerSpec(kind="ssm", moe=True),
                 "attention": LayerSpec(kind="attn", use_rope=False,
                                        moe=True)}
        p = cfg.period()
        return [Stage("hybrid_moe",
                      tuple(kinds[t] for t in cfg.layer_types[:p]),
                      cfg.n_layers // p)]
    if cfg.family == "mla_moe":
        k = cfg.first_k_dense_replace
        dense = LayerSpec(kind="mla", rope_theta=cfg.rope_theta, mlp=cfg.mlp)
        moe = LayerSpec(kind="mla", rope_theta=cfg.rope_theta, moe=True)
        return [stage for stage in (Stage("mla_dense", (dense,), k),
                                    Stage("mla_moe", (moe,), cfg.n_layers - k))
                if stage.n_periods]
    if cfg.family == "audio" and cfg.encdec is not None:
        enc = LayerSpec(kind="enc_attn", causal=False, mlp=cfg.mlp,
                        use_rope=False)
        dec = LayerSpec(kind="dec_attn", causal=True, cross=True, mlp=cfg.mlp,
                        use_rope=False)
        return [
            Stage("encoder", (enc,), cfg.encdec.n_encoder_layers, encoder=True),
            Stage("decoder", (dec,), cfg.n_layers),
        ]

    # decoder-only transformer families (dense / moe / vlm)
    moe = cfg.moe is not None
    use_mrope = cfg.mrope_sections is not None
    if cfg.local_global_ratio is not None:
        local, glob = cfg.local_global_ratio
        period = local + glob
        if cfg.n_layers % period:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                             f"periods of {period}")
        specs = tuple(
            LayerSpec(kind="attn", window=cfg.sliding_window,
                      rope_theta=10_000.0, mlp=cfg.mlp, moe=moe)
            for _ in range(local)
        ) + tuple(
            LayerSpec(kind="attn", window=None, rope_theta=cfg.rope_theta,
                      mlp=cfg.mlp, moe=moe)
            for _ in range(glob)
        )
        return [Stage("dense_lg", specs, cfg.n_layers // period)]

    spec = LayerSpec(kind="attn", window=cfg.sliding_window,
                     rope_theta=cfg.rope_theta, mlp=cfg.mlp, moe=moe,
                     use_mrope=use_mrope)
    return [Stage(cfg.family, (spec,), cfg.n_layers)]


def _layout(cfg: ModelConfig) -> Optional[HeadLayout]:
    """The head layout under the active mesh's ``tp``, or None for an
    attention-free model."""
    if cfg.n_heads == 0:
        return None
    return head_layout(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       mesh_ctx().tp)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def add_shared_experts(layer: nn.Module, moe_cfg, d: int, d_ff: int, dtype,
                       device, generator) -> None:
    """Give ``layer`` its shared experts, one SwiGLU of ``d_ff``
    (``shared_mlp``), and their gate ``shared_gate`` [d, 1] where
    ``moe_cfg.shared_gated``."""
    layer.shared_mlp = MLP("swiglu", d, d_ff, dtype, device, generator)
    if moe_cfg.shared_gated:
        layer.shared_gate = nn.Parameter(dense_init(d, 1, dtype, device,
                                                    generator))


def shared_experts(layer: nn.Module, h, y):
    """``y`` plus ``layer``'s shared experts on ``h``: behind their sigmoid
    gate in float32 where it has one (qwen2-moe), else added as they are
    (DeepSeek-V2, granite-4.0-h); ``y`` alone without shared experts."""
    if not hasattr(layer, "shared_mlp"):
        return y
    s = layer.shared_mlp(h)
    if not hasattr(layer, "shared_gate"):
        return y + s
    g = torch.sigmoid((h @ layer.shared_gate).float())
    return y + (g * s.float()).to(y.dtype)


def norm_eps(cfg: ModelConfig) -> float:
    """The eps of ``cfg``'s norms: its own where it states one
    (``MLAConfig``, ``HybridMoEConfig``), else the reference's 1e-6."""
    return getattr(cfg, "norm_eps", 1e-6)


class AttnLayer(nn.Module):
    """norm1 -> attention -> residual; for whisper's decoder, norm_x ->
    cross-attention over the encoder's output -> residual; norm2 -> MLP or
    experts -> residual (the reference's ``_attn_layer_full`` and
    ``_attn_layer_decode``).  Parameter names follow the reference's layer
    tree (``norm1``, ``attn``, ``norm_x``, ``cross``, ``norm2``, ``mlp`` or
    ``moe``, ``shared_mlp``, ``shared_gate``).  A ``mla`` template's
    ``attn`` is latent attention (``models.mla.MLA``)."""

    def __init__(self, spec: LayerSpec, cfg: ModelConfig, layout: HeadLayout,
                 device, generator):
        super().__init__()
        dtype = cfg.param_dtype()
        d, eps = cfg.d_model, norm_eps(cfg)
        self.spec, self.cfg, self.layout = spec, cfg, layout
        self.norm1 = Norm(cfg.norm, d, dtype, device, eps=eps)
        if spec.kind == "mla":
            self.attn = mla_mod.MLA(mla_mod.mla_dims(cfg), dtype, device,
                                    generator)
        else:
            self.attn = Attention(d, layout, dtype, device, generator,
                                  bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)
        if spec.cross:
            self.norm_x = Norm(cfg.norm, d, dtype, device)
            self.cross = Attention(d, layout, dtype, device, generator,
                                   bias=cfg.qkv_bias)
        if spec.moe:
            self.norm2 = Norm(cfg.norm, d, dtype, device, eps=eps)
            self.moe = moe_mod.MoE(moe_mod.moe_dims(cfg.moe, d,
                                                    mesh_ctx().tp),
                                   dtype, device, generator)
            if cfg.moe.n_shared_experts:
                add_shared_experts(self, cfg.moe, d, cfg.moe.n_shared_experts
                                   * cfg.moe.d_ff_expert, dtype, device,
                                   generator)
        elif spec.mlp is not None:
            self.norm2 = Norm(cfg.norm, d, dtype, device, eps=eps)
            self.mlp = MLP(spec.mlp, d, cfg.d_ff, dtype, device, generator)

    def _qkv(self, x, rot):
        """Projections, then the rotary ``rot`` = (cos, sin) of this
        layer's template (``Model._rotations``), if it has one."""
        h = self.norm1(x)
        q = self.attn.project_q(h)
        k, v = self.attn.project_kv(h)
        if rot is not None:
            q, k = rotate(q, *rot), rotate(k, *rot)
        return q, k, v

    def _ffn(self, x):
        """norm2 -> MLP, or the experts (plus the shared experts,
        ``shared_experts``) -> residual.  Returns (x, aux): the experts'
        float32 aux loss, None without experts."""
        if self.spec.moe:
            h = self.norm2(x)
            y, aux = self.moe(h)
            return x + shared_experts(self, h, y), aux
        if self.spec.mlp is not None:
            return x + self.mlp(self.norm2(x)), None
        return x, None

    def full(self, x, rot, *, want_cache: bool, enc_out=None):
        """Train/prefill over the whole sequence.  Returns (y, {k, v} | None,
        aux), the cache entry sized to its slot (a ring of ``window`` slots
        when the sequence is longer: slot j holds the last token with
        ``pos % window == j``), and the experts' aux loss (None without
        experts); a cross layer projects the cross K/V from ``enc_out``
        [B, T, d] and adds them to its entry as ``xk``/``xv``; a latent
        attention layer's entry is ``{ckv, kpe}``."""
        if self.spec.kind == "mla":
            with profiling.model_span("mla_mixer", x.device):
                y, entry = self.attn.prefill(self.norm1(x), rot)
            x = x + y
            del y
            with profiling.model_span("ffn", x.device):
                x, aux = self._ffn(x)
            return x, (entry if want_cache else None), aux
        S = x.shape[1]
        q, k, v = self._qkv(x, rot)
        o = flash_attention(q, k, v, self.layout, causal=self.spec.causal,
                            window=self.spec.window)
        # the output projection leaves a pending sum over the tensor axis:
        # taken here, or DTensor gathers the next matrix's weight and runs
        # that product whole on every rank
        x = shard(x + self.attn.output_proj(o), "dp", "sp", None)
        if self.spec.cross:
            xq = self.cross.project_q(self.norm_x(x))
            xk, xv = self.cross.project_kv(enc_out)
            x = shard(x + self.cross.output_proj(cross_attention(
                xq, xk, xv, self.layout)), "dp", "sp", None)
        with profiling.model_span("ffn", x.device):
            x, aux = self._ffn(x)
        x = shard(x, "dp", "sp", None)
        if not want_cache:
            return x, None, aux
        w = self.spec.window
        if w is not None and S > w:
            k, v = _ring(k[:, -w:], S % w), _ring(v[:, -w:], S % w)
        entry = {"k": k, "v": v}
        if self.spec.cross:
            entry["xk"], entry["xv"] = xk, xv
        return x, entry, aux

    def decode(self, x, rot, entry, step: "DecodeStep"):
        """One token against a cache entry [B, Sc, KVs, Dh] (a latent
        attention layer's ``{ckv, kpe}``), written in place at ``step``'s
        slot for this cache (``DecodeStep.slots``)."""
        if self.spec.kind == "mla":
            x = x + self.attn.decode(self.norm1(x), rot, entry, step)
            return self._ffn(x)[0]
        q, k, v = self._qkv(x, rot)
        kc, vc = entry["k"], entry["v"]
        Sc = kc.shape[1]
        ring = self.spec.window is not None and Sc <= self.spec.window
        idx, cache_pos = step.slots(Sc, ring)
        write_slot(kc, k, idx)
        write_slot(vc, v, idx)
        o = decode_attention(q, kc, vc, step.valid, cache_pos, self.layout,
                             window=self.spec.window)
        x = shard(x + self.attn.output_proj(o), "dp", "sp", None)
        if self.spec.cross:
            xk, xv = entry["xk"], entry["xv"]
            valid, pos = step.every_slot(xk.shape[1])
            xq = self.cross.project_q(self.norm_x(x))
            x = shard(x + self.cross.output_proj(decode_attention(
                xq, xk, xv, valid, pos, self.layout)), "dp", "sp", None)
        return shard(self._ffn(x)[0], "dp", "sp", None)


def _ring(t, shift: int):
    """``torch.roll(t, shift, dims=1)`` as two slices and a cat, ops that
    DTensor can lay out (it has no rule for roll)."""
    if shift == 0:
        return t
    return torch.cat([t[:, -shift:], t[:, :-shift]], dim=1)


class SsmLayer(nn.Module):
    """norm -> Mamba block -> residual (the reference's ``_ssm_layer``);
    parameter names follow its layer tree (``norm``, ``ssm``)."""

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        dtype = cfg.param_dtype()
        self.norm = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.ssm = ssm_mod.Mamba(ssm_mod.ssm_dims(cfg.ssm, cfg.d_model),
                                 dtype, device, generator)

    def full(self, x, rot, *, want_cache: bool, enc_out=None):
        """Prefill from scratch: (y, {conv, ssm} | None, None), the final
        states (and no aux loss)."""
        y, state = self.ssm(self.norm(x))
        x = shard(x + y, "dp", "sp", None)
        return x, (state if want_cache else None), None

    def decode(self, x, rot, entry, step: "DecodeStep"):
        """One token from the states in ``entry``, which it overwrites with
        the new states, in place."""
        y, _ = self.ssm(self.norm(x), entry, in_place=True)
        return shard(x + y, "dp", "sp", None)


class HybridMoELayer(nn.Module):
    """A layer of granite-4.0-h (``HybridMoEConfig``): norm1 -> its mixer,
    the published Mamba-2 (``ssm``) or GQA attention without positions
    (``attn``, scores scaled by ``attention_multiplier``) -> ``x + m y``;
    norm2 -> the experts plus the ungated shared expert (``moe``,
    ``shared_mlp``) -> ``x + m y``; ``m`` is the residual multiplier and
    every norm takes the configuration's eps.  A prefill times the mixer
    and the feed-forward under ``profiling.model_span``."""

    def __init__(self, spec: LayerSpec, cfg: HybridMoEConfig,
                 layout: HeadLayout, device, generator):
        super().__init__()
        dtype = cfg.param_dtype()
        d, eps = cfg.d_model, cfg.norm_eps
        self.spec, self.layout = spec, layout
        self.res = cfg.residual_multiplier
        self.norm1 = Norm(cfg.norm, d, dtype, device, eps=eps)
        if spec.kind == "ssm":
            self.ssm = ssm_mod.Mamba2(ssm_mod.ssm_dims(cfg.ssm, d), eps,
                                      dtype, device, generator)
        else:
            self.attn = Attention(d, layout, dtype, device, generator)
            # the kernels scale the scores by 1/sqrt(Dh); q carries the rest
            self.q_scale = cfg.attention_multiplier * math.sqrt(
                layout.d_head)
        self.norm2 = Norm(cfg.norm, d, dtype, device, eps=eps)
        self.moe = moe_mod.MoE(moe_mod.moe_dims(cfg.moe, d, mesh_ctx().tp),
                               dtype, device, generator)
        add_shared_experts(self, cfg.moe, d, cfg.shared_d_ff, dtype, device,
                           generator)

    def _qkv(self, h):
        q = self.attn.project_q(h)
        k, v = self.attn.project_kv(h)
        return (q.float() * self.q_scale).to(q.dtype), k, v

    def _ffn(self, x):
        """(x + m (experts + shared expert)(norm2 x), the experts' aux)."""
        h = self.norm2(x)
        y, aux = self.moe(h)
        return x + shared_experts(self, h, y) * self.res, aux

    def full(self, x, rot, *, want_cache: bool, enc_out=None):
        """Prefill from scratch: (y, the cache entry | None, aux); the
        entry is the final ``{conv, ssm}`` states or the ``{k, v}``."""
        h = self.norm1(x)
        if self.spec.kind == "ssm":
            with profiling.model_span("ssm_mixer", x.device):
                y, entry = self.ssm(h)
        else:
            with profiling.model_span("attn_mixer", x.device):
                q, k, v = self._qkv(h)
                y = self.attn.output_proj(flash_attention(
                    q, k, v, self.layout, causal=True))
            entry = {"k": k, "v": v}
        del h
        x = x + y * self.res
        with profiling.model_span("ffn", x.device):
            x, aux = self._ffn(x)
        return x, (entry if want_cache else None), aux

    def decode(self, x, rot, entry, step: "DecodeStep"):
        """One token against ``entry``, which it updates in place: the
        Mamba-2 states, or the K/V at ``step``'s slot."""
        h = self.norm1(x)
        if self.spec.kind == "ssm":
            y, _ = self.ssm(h, entry, in_place=True)
        else:
            q, k, v = self._qkv(h)
            kc, vc = entry["k"], entry["v"]
            idx, cache_pos = step.slots(kc.shape[1], False)
            write_slot(kc, k, idx)
            write_slot(vc, v, idx)
            y = self.attn.output_proj(decode_attention(
                q, kc, vc, step.valid, cache_pos, self.layout))
        return self._ffn(x + y * self.res)[0]


class DecodeStep:
    """What every layer of one decode step shares, computed once per step
    rather than once per layer: the valid length after the write (int32,
    [B]) and, per cache size, the write slot and each slot's absolute
    position (int32, [B, Sc]).

    Full layers write slot ``cache_len``, clamped to the last slot as the
    reference's dynamic_update_slice does, and slot j holds position j.
    Window layers with ``Sc <= window`` are a ring: they write slot
    ``cache_len % Sc``, and after the write slot j holds position
    ``cache_len - ((cache_len - j) mod Sc)``.  Cross-attention reads a cache
    whose every slot is valid (``every_slot``)."""

    def __init__(self, cache_len, batch: int, device):
        self.clen = torch.as_tensor(cache_len, device=device).to(torch.int32)
        self.batch = batch
        self.valid = (self.clen + 1).expand(batch)
        self._slots: Dict[Tuple[int, bool], tuple] = {}

    def slots(self, Sc: int, ring: bool):
        """(write index [1] int64, slot positions [B, Sc] int32)."""
        key = (Sc, ring)
        if key not in self._slots:
            clen = self.clen
            j = torch.arange(Sc, device=clen.device, dtype=torch.int32)
            if ring:
                slot, pos = torch.remainder(clen, Sc), clen - torch.remainder(
                    clen - j, Sc)
            else:
                slot, pos = torch.clamp(clen, max=Sc - 1), j
            self._slots[key] = (slot.reshape(1).long(),
                                pos.expand(self.batch, Sc))
        return self._slots[key]

    def every_slot(self, Sc: int):
        """(valid length [B] = Sc, slot positions [B, Sc]) int32, for a
        cache of ``Sc`` slots all valid: whisper's encoder context, which
        the reference's decode attends with ``cache_len = T``."""
        key = (Sc, "all")
        if key not in self._slots:
            dev = self.clen.device
            self._slots[key] = (
                torch.full((1,), Sc, dtype=torch.int32,
                           device=dev).expand(self.batch),
                torch.arange(Sc, dtype=torch.int32,
                             device=dev).expand(self.batch, Sc))
        return self._slots[key]


# ---------------------------------------------------------------------------
# logits and the training loss
# ---------------------------------------------------------------------------


def embed_lookup(table, tokens):
    """Token embeddings [B, S, d] from ``table`` [Vp, d].  Under a mesh
    with ``tp > 1`` the table is sharded on the vocabulary: each rank
    gathers the rows it holds (zero for the others) and the rows are
    summed over ``"model"`` (the reference's masked gather + psum)."""
    ctx = mesh_ctx()
    if not ctx.active or ctx.tp == 1:
        return F.embedding(tokens, table)

    def body(tbl, tok):
        v_loc = tbl.shape[0]
        idx = tok - coordinate("model") * v_loc
        ok = (idx >= 0) & (idx < v_loc)
        y = F.embedding(idx.clamp(0, v_loc - 1), tbl)
        return psum(torch.where(ok[..., None], y, torch.zeros_like(y)),
                    "model")

    bspec = spec_for(tokens.shape, "dp")[0]
    return shard_map(body, ctx.mesh, (("model", None), (bspec, None)),
                     (bspec, None, None))(table, tokens)


def lm_logits(x, table):
    """x: [B, S, d]; table: [Vp, d] -> logits [B, S, Vp] in x's dtype,
    sharded on the vocabulary under a mesh."""
    return shard(x @ table.T, "dp", None, "tp")


def _ce_chunk(x, table, targets, vocab_size: int):
    """Sum over one chunk's tokens of logsumexp(logits) - logit[target], in
    float32, vocabulary padding masked to -1e30.  DTensors run on each
    rank's tokens and vocabulary shard (``_ce_chunk_sharded``)."""
    if is_dtensor(x):
        return _ce_chunk_sharded(x, table, targets, vocab_size)
    logits = lm_logits(x, table).float()
    v = logits.shape[-1]
    if v > vocab_size:
        pad = torch.arange(v, device=logits.device) >= vocab_size
        logits = torch.where(pad, torch.full_like(logits, -1e30), logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (logz - gold).sum()


def _ce_chunk_sharded(x, table, targets, vocab_size: int):
    """``_ce_chunk`` on shards: each rank takes the logits of its tokens
    over its vocabulary shard; the log-sum-exp and the target's logit are
    reduced over the table's tensor axes (the max with no gradient, which
    cancels from it) and the tokens' sum over their data axes."""
    ctx = mesh_ctx()
    vspec = spec_of(table)[0]
    tp = () if vspec is None else ((vspec,) if isinstance(vspec, str)
                                   else vspec)
    bspec = spec_for(x.shape, "dp")[0]
    dp = () if bspec is None else ((bspec,) if isinstance(bspec, str)
                                   else bspec)

    def body(x, tbl, tgt):
        v_loc = tbl.shape[0]
        lo = shard_index(vspec) * v_loc
        logits = (x @ tbl.T).float()                        # [b, T, V_loc]
        vid = lo + torch.arange(v_loc, device=logits.device)
        logits = torch.where(vid >= vocab_size,
                             torch.full_like(logits, -1e30), logits)
        m = pmax(logits.detach().amax(-1), tp)
        logz = m + torch.log(psum(torch.exp(logits - m[..., None]).sum(-1),
                                  tp))
        idx = tgt.long() - lo
        ok = (idx >= 0) & (idx < v_loc)
        gold = logits.gather(-1, idx.clamp(0, v_loc - 1)[..., None])[..., 0]
        gold = psum(torch.where(ok, gold, torch.zeros_like(gold)), tp)
        return psum((logz - gold).sum(), dp)

    return shard_map(body, ctx.mesh, ((bspec, None, None), (vspec, None),
                                      (bspec, None)), ())(x, table, targets)


def chunked_ce(x, table, targets, vocab_size: int, n_chunks: int = 8):
    """Mean cross-entropy without materializing the [B, S, Vp] logits (the
    reference's ``chunked_ce``): the sequence is split into ``n_chunks``
    (halved until it divides S), each chunk computes its logits and CE sum
    under ``torch.utils.checkpoint``, so the backward pass recomputes them
    and at most one chunk's logits are live, as the reference's
    ``jax.checkpoint`` scan body does."""
    B, S, _ = x.shape
    while S % n_chunks != 0:
        n_chunks //= 2
    n_chunks = max(n_chunks, 1)
    T = S // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * T, (c + 1) * T)
        total = total + checkpoint(_ce_chunk, x[:, sl], table,
                                   targets[:, sl], vocab_size,
                                   use_reentrant=False)
    return total / (B * S)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _on_mesh(fn):
    """Run a ``Model`` entry point where plain tensors count as replicated
    next to DTensors (``replicated_inputs``; nothing without a mesh)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with replicated_inputs():
            return fn(*args, **kwargs)
    return run


class Model(nn.Module):
    """Embedding, stages of ``AttnLayer``/``SsmLayer`` periods, final norm,
    logits; whisper's encoder stage and ``enc_norm`` besides.

    ``generator`` draws the weights as the reference's ``init_params``
    shapes them (normal, 1/sqrt(d_in) for dense weights, 0.02 for
    embeddings, zero biases, unit norm scales); ``device=None`` means the
    card.  On the ``meta`` device nothing is drawn (``convert`` fills the
    weights)."""

    def __init__(self, cfg: ModelConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        device = resolve_device(device)
        if device.type != "meta" and generator is None:
            raise ValueError("weights are drawn from an explicit "
                             "torch.Generator: pass generator=")
        self.cfg = cfg
        self.plan = build_plan(cfg)
        self.layout = _layout(cfg)
        dtype = cfg.param_dtype()
        self.embed = nn.Parameter(embed_init(cfg.padded_vocab, cfg.d_model,
                                             dtype, device, generator))
        self.final_norm = Norm(cfg.norm, cfg.d_model, dtype, device,
                               eps=norm_eps(cfg))
        # granite-4.0-h's embedding and logits multipliers
        hybrid_moe = isinstance(cfg, HybridMoEConfig)
        self.embed_scale = self.logits_scaling = None
        if hybrid_moe:
            self.embed_scale = cfg.embedding_multiplier
            self.logits_scaling = cfg.logits_scaling
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(embed_init(
                cfg.padded_vocab, cfg.d_model, dtype, device, generator))
        if cfg.family == "hybrid":
            # one copy, looked up by every period (``_layer``)
            self.shared_block = AttnLayer(self.plan[0].specs[0], cfg,
                                          self.layout, device, generator)
        # whisper's encoder stage (None elsewhere), and the stages tokens
        # run through, each with a cache
        self.encoder_stage = next((s for s in self.plan if s.encoder), None)
        self.decoder_stages = [s for s in self.plan if not s.encoder]
        if self.encoder_stage is not None:
            self.enc_norm = Norm(cfg.norm, cfg.d_model, dtype, device)
        # decode_multi's captured steps on the card, made at first use
        self.graphs: Optional[GraphCache] = None

        def layer(spec):
            if hybrid_moe:
                return HybridMoELayer(spec, cfg, self.layout, device,
                                      generator)
            if spec.kind == "ssm":
                return SsmLayer(cfg, device, generator)
            return AttnLayer(spec, cfg, self.layout, device, generator)

        self.stages = nn.ModuleDict({
            stage.name: nn.ModuleList(
                nn.ModuleDict({
                    f"layer{li}": layer(spec)
                    for li, spec in enumerate(stage.specs)
                    if spec.kind != "shared_attn"})
                for _ in range(stage.n_periods))
            for stage in self.plan})

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _layer(self, period, li: int, spec: LayerSpec) -> nn.Module:
        """The module of template ``li`` in one period: the shared block
        for ``shared_attn`` templates (the reference's ``_period_params``)."""
        if spec.kind == "shared_attn":
            return self.shared_block
        return period[f"layer{li}"]

    def _table(self):
        """The unembedding table [Vp, d]: the embedding when tied."""
        return self.embed if self.cfg.tie_embeddings else self.lm_head

    def _logits(self, x):
        return lm_logits(x, self._table())

    def _final(self, x):
        """The final norm; for granite-4.0-h then the 1/``logits_scaling``
        of its logits, taken here so that every head (``_logits``,
        ``chunked_ce``) reads it."""
        x = self.final_norm(x)
        return x if self.logits_scaling is None else x / self.logits_scaling

    def _rotations(self, positions, extras):
        """The rotary cos/sin of each layer template, computed once per call
        and shared by every layer of that template: {spec: (cos, sin) |
        None}.  ``positions`` [S] or [1, 1] are the tokens' absolute
        positions; M-RoPE templates read ``extras["mrope_positions"]``."""
        out = {}
        for spec in {s for stage in self.plan for s in stage.specs}:
            if spec.kind == "ssm":
                out[spec] = None
                continue
            if spec.kind == "mla":
                cfg = self.cfg
                out[spec] = (rope_cos_sin(positions, cfg.qk_rope_head_dim,
                                          spec.rope_theta)
                             if cfg.rope_scaling is None else yarn_cos_sin(
                                 positions, cfg.qk_rope_head_dim,
                                 spec.rope_theta, cfg.rope_scaling))
                continue
            dh = self.layout.d_head
            if spec.use_mrope:
                out[spec] = mrope_cos_sin(extras["mrope_positions"], dh,
                                          spec.rope_theta,
                                          self.cfg.mrope_sections)
            elif spec.use_rope:
                out[spec] = rope_cos_sin(positions, dh, spec.rope_theta)
            else:
                out[spec] = None
        return out

    def _embed_tokens(self, tokens, start=0):
        """Token embeddings; whisper's decoder adds the sinusoidal
        embedding of positions ``start + arange(S)`` (``start`` is a
        device tensor at decode: no host sync)."""
        x = embed_lookup(self.embed, tokens)
        if self.embed_scale is not None:
            x = x * self.embed_scale
        if self.cfg.family == "audio":
            pos = start + torch.arange(tokens.shape[1], device=self.device)
            x = x + sinusoid_embed(pos, self.cfg.d_model).to(x.dtype)[None]
        return shard(x, "dp", "sp", None)

    def _run_period(self, stage: Stage, period, x, rot, *, want_cache: bool,
                    enc_out=None, remat: bool = False):
        """One period of ``stage`` over the whole sequence: (x, {"layer{i}":
        entry | None}, aux | None), aux the sum of its moe layers' aux
        losses.  With ``remat`` the period runs under
        ``torch.utils.checkpoint`` and only its input is kept for the
        backward pass, which runs it again (the reference's
        ``jax.checkpoint(period_body)``)."""
        def body(x):
            entries, aux = {}, None
            for li, spec in enumerate(stage.specs):
                x, e, a = self._layer(period, li, spec).full(
                    x, rot[spec] if rot is not None else None,
                    want_cache=want_cache, enc_out=enc_out)
                entries[f"layer{li}"] = e
                if a is not None:
                    aux = a if aux is None else aux + a
            return x, entries, aux
        if remat:
            return checkpoint(body, x, use_reentrant=False)
        return body(x)

    def _encode(self, frames, *, remat: bool = False):
        """Whisper's encoder: frames [B, T, d] (the conv frontend is a stub)
        plus sinusoidal positions -> the encoder stage's bidirectional,
        rope-free layers (B3) -> ``enc_norm``."""
        T = frames.shape[1]
        x = frames + sinusoid_positions(T, self.cfg.d_model,
                                        frames.device).to(frames.dtype)[None]
        x = shard(x, "dp", "sp", None)
        stage = self.encoder_stage
        for period in self.stages[stage.name]:
            x, _, _ = self._run_period(stage, period, x, None,
                                       want_cache=False, remat=remat)
        return self.enc_norm(x)

    @_on_mesh
    def backbone(self, tokens, extras=None, *, want_cache: bool = False,
                 remat: bool = False):
        """Embeddings -> stages -> final norm.  Returns (hidden [B, S, d],
        cache | None, aux): aux is the moe layers' aux loss summed per
        period, then over each stage's periods, then over the stages, in
        float32 (zero without experts), as the reference sums it.  Whisper
        takes ``extras["frames"]`` [B, T, d].  ``remat``: each period under
        ``torch.utils.checkpoint`` (training; no cache)."""
        extras = extras or {}
        if remat and want_cache:
            raise ValueError("remat recomputes the periods in the backward "
                             "pass and keeps no cache")
        enc_out = None
        if self.encoder_stage is not None:
            if "frames" not in extras:
                raise ValueError(f"{self.cfg.name} encodes extras['frames'] "
                                 f"[B, T, d] before its decoder")
            enc_out = self._encode(extras["frames"], remat=remat)
        S = tokens.shape[1]
        x = self._embed_tokens(tokens)
        rot = self._rotations(torch.arange(S, device=self.device), extras)
        cache: Dict[str, dict] = {}
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for stage in self.decoder_stages:
            entries = {f"layer{li}": [] for li in range(len(stage.specs))}
            auxs = []
            for period in self.stages[stage.name]:
                x, es, a = self._run_period(stage, period, x, rot,
                                            want_cache=want_cache,
                                            enc_out=enc_out, remat=remat)
                if a is not None:
                    auxs.append(a)
                if want_cache:
                    for key, e in es.items():
                        entries[key].append(e)
            if auxs:
                aux = aux + torch.stack(auxs).sum()
            if want_cache:
                cache[stage.name] = {
                    key: {n: torch.stack([e[n] for e in es]) for n in es[0]}
                    for key, es in entries.items()}
        x = self._final(x)
        return x, (cache if want_cache else None), aux

    @_on_mesh
    def loss_fn(self, batch, *, remat: bool = False, unroll: bool = False,
                aux_weight: float = 0.01, ce_chunks: int = 8):
        """The training loss of ``batch`` ({"tokens", "targets"} [B, S] and
        the modality extras: ``frames``, ``mrope_positions``): the chunked
        cross-entropy plus ``aux_weight`` times the moe aux loss.  Returns
        (loss, {"ce", "aux"}), float32 0-d tensors.  ``unroll`` is the
        reference's scan unrolling, kept for its signature: eager PyTorch
        runs every loop unrolled, so it changes nothing."""
        extras = {k: v for k, v in batch.items()
                  if k not in ("tokens", "targets")}
        x, _, aux = self.backbone(batch["tokens"], extras, remat=remat)
        ce = chunked_ce(x, self._table(), batch["targets"],
                        self.cfg.vocab_size, n_chunks=ce_chunks)
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}

    @_on_mesh
    def forward(self, tokens, extras=None):
        """Full forward returning dense logits [B, S, Vp]."""
        return self._logits(self.backbone(tokens, extras)[0])

    @torch.no_grad()
    @_on_mesh
    def prefill(self, tokens, extras=None):
        """Returns (last-token logits [B, 1, Vp], cache)."""
        x, cache, _ = self.backbone(tokens, extras, want_cache=True)
        return self._logits(x[:, -1:]), cache

    @torch.no_grad()
    @_on_mesh
    def decode_step(self, tokens, cache, cache_len, extras=None):
        """One decode step: tokens [B, 1] against a cache with ``cache_len``
        valid entries (int or 0-d tensor).  Writes the new K/V and ssm
        states into ``cache`` in place; returns (logits [B, 1, Vp], cache)."""
        step = DecodeStep(cache_len, tokens.shape[0], self.device)
        rot = self._rotations(step.clen.reshape(1, 1), extras or {})
        x = self._embed_tokens(tokens, step.clen)
        for stage in self.decoder_stages:
            for p, period in enumerate(self.stages[stage.name]):
                for li, spec in enumerate(stage.specs):
                    key = f"layer{li}"
                    entry = {n: t[p] for n, t in cache[stage.name][key].items()}
                    x = self._layer(period, li, spec).decode(x, rot[spec],
                                                             entry, step)
        x = self._final(x)
        return self._logits(x), cache

    @torch.no_grad()
    def decode_multi(self, tokens, cache, cache_len, n_steps: int,
                     extras=None, *, eos_id: Optional[int] = None):
        """Greedy decode of ``n_steps`` tokens without leaving the device:
        argmax over the real vocabulary and EOS masking run on the card,
        and nothing is read back to the host (the reference's ``lax.scan``
        body, step for step).  Returns (generated [B, n_steps] int32, cache,
        new cache_len); ``extras`` are the same for every step, as in the
        reference.  Sequences that hit ``eos_id`` emit it thereafter.

        The step reads and writes static buffers (``_MultiState``): the
        carried token, the length, the EOS mask and the token column, which
        a device index picks.  On the card one step is captured as a CUDA
        graph and replayed ``n_steps`` times (``kernels._graph``; the
        graphs are held in ``Model.graphs``), keyed by
        the batch, ``n_steps``, ``eos_id`` and the storage of the cache,
        of ``extras``' tensors and of the weights; a cache with new storage
        is captured anew.  CPU tensors run the same step eagerly.  The
        outputs are copies of the static buffers, which a later call
        overwrites."""
        B = tokens.shape[0]
        if self.device.type == "cuda":
            if self.graphs is None:
                self.graphs = GraphCache(capacity=MULTI_GRAPHS)
            leaves = [t for layers in cache.values()
                      for names in layers.values() for t in names.values()]
            ext = [t for t in (extras or {}).values()
                   if isinstance(t, torch.Tensor)]
            entry = self.graphs.entry(
                (B, n_steps, eos_id, storage_key(*leaves, *ext),
                 tuple(p.data_ptr() for p in self.parameters())),
                lambda: _MultiState(B, n_steps, self.device))
            st = entry.state
        else:
            entry, st = None, _MultiState(B, n_steps, self.device)
        st.tok.copy_(tokens)
        if isinstance(cache_len, torch.Tensor):
            st.clen.copy_(cache_len.reshape(()))
        else:
            st.clen.fill_(cache_len)
        st.done.zero_()
        st.idx.zero_()

        def step():
            logits, _ = self.decode_step(st.tok, cache, st.clen, extras)
            nxt = logits[:, 0, :self.cfg.vocab_size].argmax(-1).to(
                torch.int32)
            if eos_id is not None:
                nxt = torch.where(st.done, torch.full_like(nxt, eos_id), nxt)
                st.done.logical_or_(nxt == eos_id)
            st.out.index_copy_(1, st.idx, nxt[:, None])
            st.tok.copy_(nxt[:, None])
            st.clen.add_(1)
            st.idx.add_(1)

        if entry is None:
            for _ in range(n_steps):
                step()
        else:
            self.graphs.run(entry, step, n_steps)
        return st.out.clone(), cache, st.clen.clone()


# decode_multi's graphs held at most.  Its key holds the caller's cache
# storage, so a caller that makes a new cache for each call (a clone per
# timed run, a fresh prefill per batch) would otherwise keep a dead graph
# per cache; a server or the calibration keeps one cache per batch shape
# and reuses its graph, and 8 leaves room for a few such callers at once.
MULTI_GRAPHS = 8


class _MultiState:
    """``decode_multi``'s static buffers: the carried token [B, 1] and the
    length (0-d), int32; the EOS mask [B]; the step index [1]; the
    generated tokens [B, n_steps] int32."""

    def __init__(self, batch: int, n_steps: int, device):
        i32 = dict(dtype=torch.int32, device=device)
        self.tok = torch.empty((batch, 1), **i32)
        self.clen = torch.empty((), **i32)
        self.done = torch.empty(batch, dtype=torch.bool, device=device)
        self.idx = torch.empty(1, dtype=torch.int64, device=device)
        self.out = torch.empty((batch, n_steps), **i32)


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------


def _entry_specs(spec: LayerSpec, cfg: ModelConfig, layout, batch: int,
                 seq: int):
    """One layer's cache entry as ``meta`` tensors, without the period
    axis."""
    dtype = cfg.param_dtype()
    if spec.kind == "ssm":
        dims = ssm_mod.ssm_dims(cfg.ssm, cfg.d_model)
        return ssm_mod.ssm_state_specs(dims, batch, dtype)
    if spec.kind == "mla":
        return mla_mod.mla_entry_specs(mla_mod.mla_dims(cfg), batch, seq,
                                       dtype)
    sc = min(seq, spec.window) if spec.window is not None else seq
    shapes = {n: (batch, sc, layout.kv_store, layout.d_head)
              for n in ("k", "v")}
    if spec.cross:
        shapes.update({n: (batch, cfg.encdec.n_encoder_ctx, layout.kv_store,
                           layout.d_head) for n in ("xk", "xv")})
    return {n: torch.empty(shape, dtype=dtype, device="meta")
            for n, shape in shapes.items()}


def cache_specs(cfg: ModelConfig, batch: int, seq: int):
    """The cache tree of prefill/decode as ``meta`` tensors (shape and
    dtype): window layers hold ``min(seq, window)`` slots, ssm layers
    their fixed-size states, cross layers the encoder context's K/V,
    latent attention layers ``seq`` slots of ``c_kv`` and ``k_pe``."""
    layout = _layout(cfg)
    out = {}
    for stage in build_plan(cfg):
        if stage.encoder:
            continue
        st = {}
        for li, spec in enumerate(stage.specs):
            st[f"layer{li}"] = {
                n: torch.empty((stage.n_periods, *t.shape), dtype=t.dtype,
                               device="meta")
                for n, t in _entry_specs(spec, cfg, layout, batch,
                                         seq).items()}
        out[stage.name] = st
    return out


def grow_cache(cache, cfg: ModelConfig, batch: int, seq: int):
    """A prefill cache zero-padded to ``cache_specs(cfg, batch, seq)``, as
    the reference's callers pad theirs before decoding (ssm states and the
    cross K/V keep their size and are copied; the latent cache grows on
    its slots, as K/V do)."""
    out = {}
    for stage, layers in cache_specs(cfg, batch, seq).items():
        out[stage] = {}
        for key, entry in layers.items():
            out[stage][key] = {}
            for n, spec in entry.items():
                old = cache[stage][key][n]
                new = old.new_zeros(spec.shape)
                new[tuple(slice(0, s) for s in old.shape)] = old
                out[stage][key][n] = new
    return out


# ---------------------------------------------------------------------------
# sharding: the reference's spec trees, and the placed model
# ---------------------------------------------------------------------------


def _norm_axes(cfg: ModelConfig):
    if cfg.norm == "nonparametric_ln":
        return {}
    return {k: (None,) for k in
            ("scale", "bias")[:1 if cfg.norm == "rmsnorm" else 2]}


def _layer_axes(spec: LayerSpec, cfg: ModelConfig, layout):
    """One layer's parameter axes (the reference's ``_layer_axes``)."""
    a: Dict[str, Any] = {}
    if spec.kind == "ssm":
        a["norm"] = _norm_axes(cfg)
        a["ssm"] = ssm_mod.ssm_param_axes(
            ssm_mod.ssm_dims(cfg.ssm, cfg.d_model))
        return a
    a["norm1"] = _norm_axes(cfg)
    a["attn"] = (mla_mod.mla_param_axes() if spec.kind == "mla" else
                 attn_param_axes(layout, bias=cfg.qkv_bias,
                                 qk_norm=cfg.qk_norm))
    if spec.cross:
        a["norm_x"] = _norm_axes(cfg)
        a["cross"] = attn_param_axes(layout, bias=cfg.qkv_bias)
    if spec.moe:
        a["norm2"] = _norm_axes(cfg)
        a["moe"] = moe_mod.moe_param_axes()
        if cfg.moe.n_shared_experts:
            a["shared_mlp"] = {"w_gate": (None, "tp"), "w_up": (None, "tp"),
                               "w_down": ("tp", None)}
            if cfg.moe.shared_gated:
                a["shared_gate"] = (None, None)
    elif spec.mlp is not None:
        a["norm2"] = _norm_axes(cfg)
        a["mlp"] = (
            {"w_gate": (None, "tp"), "w_up": (None, "tp"),
             "w_down": ("tp", None)}
            if spec.mlp in ("swiglu", "geglu") else
            {"w_up": (None, "tp"), "b_up": ("tp",), "w_down": ("tp", None),
             "b_down": (None,)})
    return a


def _stack_axes(tree):
    """A replicated period axis in front of every axes tuple."""
    return tree_map(lambda a: (None,) + a, tree)


def param_axes(cfg: ModelConfig):
    """The logical sharding axes of every parameter, as the reference's
    ``param_axes`` tree (a stage's leaves with their period axis)."""
    layout = _layout(cfg)
    axes: Dict[str, Any] = {"embed": ("tp", None),
                            "final_norm": _norm_axes(cfg)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("tp", None)
    if cfg.family == "hybrid":
        axes["shared_block"] = _layer_axes(
            LayerSpec(kind="shared_attn", mlp=cfg.mlp), cfg, layout)
    for stage in build_plan(cfg):
        axes[stage.name] = {
            f"layer{li}": _stack_axes(_layer_axes(spec, cfg, layout))
            for li, spec in enumerate(stage.specs)
            if spec.kind != "shared_attn"}
    if cfg.family == "audio" and cfg.encdec is not None:
        axes["enc_norm"] = _norm_axes(cfg)
    return axes


def _reference_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """A parameter name -> (its reference tree path, its period or None):
    ``stages.<stage>.<p>.rest`` is leaf ``<stage>.rest``, period ``p``."""
    parts = tuple(name.split("."))
    if parts[0] == "stages":
        return (parts[1],) + parts[3:], int(parts[2])
    return parts, None


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def param_shapes(cfg: ModelConfig):
    """The reference's parameter tree of shapes (``torch.Size``; a stage's
    leaves with their period axis), under the active mesh's layout."""
    model = Model(cfg, device="meta")
    periods = {s.name: s.n_periods for s in model.plan}
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        path, per = _reference_path(name)
        shape = p.shape if per is None else torch.Size(
            (periods[path[0]], *p.shape))
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = shape
    return tree


def _to_spec(ax, shape):
    ax = tuple(ax) + (None,) * (len(shape) - len(ax))
    return spec_for(shape, *ax)


def param_shardings(cfg: ModelConfig, params_shape=None):
    """The spec of every parameter leaf (the reference's
    ``param_shardings``, a spec tuple for each NamedSharding), or None per
    leaf with no mesh.  ``params_shape`` defaults to ``param_shapes``."""
    shapes = params_shape if params_shape is not None else param_shapes(cfg)
    active = mesh_ctx().active
    return tree_map(lambda ax, shape: _to_spec(ax, tuple(shape))
                     if active else None, param_axes(cfg), shapes)


def port_specs(model: "Model", tree) -> Dict[str, Any]:
    """A tree keyed by the reference's paths (``param_shardings``,
    ``zero1_shardings``) as ``{parameter name: spec}`` for ``model``: a
    period's parameter takes its stage leaf's spec without the period
    entry."""
    out = {}
    for name, _ in model.named_parameters():
        path, per = _reference_path(name)
        spec = _get(tree, path)
        out[name] = spec if spec is None or per is None else spec[1:]
    return out


def place_params(model: "Model", shardings=None) -> "Model":
    """Lay ``model``'s parameters out on the active mesh as DTensors, by
    ``shardings`` (``param_shardings``' tree by default).  Each rank holds
    the same global weights, and keeps its shard of them (no
    communication).  Returns ``model``."""
    if not mesh_ctx().active:
        return model
    specs = port_specs(model, shardings if shardings is not None
                       else param_shardings(model.cfg))
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = nn.Parameter(
            place(p.detach(), specs[name]), requires_grad=p.requires_grad)
    return model


def _cache_entry_axes(spec: LayerSpec, cfg: ModelConfig, layout):
    """One layer's cache axes (the reference's ``_entry_axes``): kv heads
    on ``tp`` when they divide it, else the slots."""
    if spec.kind == "ssm":
        dims = ssm_mod.ssm_dims(cfg.ssm, cfg.d_model)
        if dims.version == 1:
            return {"conv": ("dp", None, "tp"), "ssm": ("dp", "tp", None)}
        return {"conv": ("dp", None, "tp"),
                "ssm": ("dp", "tp", None, None)}
    if spec.kind == "mla":
        # one latent and one rotary key a token, shared by every head
        return {"ckv": ("dp", None, None), "kpe": ("dp", None, None)}
    kv_ax = ("tp" if layout is not None
             and layout.kv_store % mesh_ctx().tp == 0 else None)
    seq_ax = None if kv_ax == "tp" else "tp"
    e = {"k": ("dp", seq_ax, kv_ax, None), "v": ("dp", seq_ax, kv_ax, None)}
    if spec.cross:
        e["xk"] = ("dp", None, kv_ax, None)
        e["xv"] = ("dp", None, kv_ax, None)
    return e


def cache_axes(cfg: ModelConfig):
    """The cache tree's logical axes (the reference's ``cache_axes``)."""
    layout = _layout(cfg)
    return {stage.name: {
        f"layer{li}": _stack_axes(_cache_entry_axes(spec, cfg, layout))
        for li, spec in enumerate(stage.specs)}
        for stage in build_plan(cfg) if not stage.encoder}


def cache_shardings(cfg: ModelConfig, specs):
    """The spec of every cache leaf of ``specs`` (``cache_specs``' tree),
    or None per leaf with no mesh."""
    active = mesh_ctx().active
    return tree_map(lambda ax, leaf: _to_spec(ax, tuple(leaf.shape))
                     if active else None, cache_axes(cfg), specs)


def place_tree(tree, shardings):
    """Every tensor of ``tree`` laid out by its spec in ``shardings`` (a
    tree of the same keys; a None spec leaves the tensor as it is)."""
    return tree_map(lambda t, spec: t if spec is None else place(t, spec),
                     tree, shardings)
