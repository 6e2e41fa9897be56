"""GQA attention with the reference's head layout: the port of
``src/repro/models/attention.py``.

``HeadLayout``/``head_layout`` are the reference's, pure Python, with ``tp``
an argument that defaults to 1 (one card, no mesh).  ``duplicated_kv`` is
the reference's train-time scope in which ``head_layout`` stores each kv
head ``tp // kv`` times (at most 2) so that the kv weights shard on the
tensor axis; it acts only at ``tp > 1``, so on one card it changes
nothing.

Activations are ``[B, S, Hp, Dh]`` and caches ``[B, Sc, KVs, Dh]``, as in
the reference.  ``flash_attention`` and ``decode_attention`` call the
kernels through ``repro_torch.kernels.ops`` with transposed views of those
tensors (``[B, H, S, D]``, ``[B, KV, S, D]``): the kernels read them through
their strides, so no copy of an activation or of the cache is made.  On
the CPU the same calls compute the kernels' plain versions, which the
tests hold against the reference's jnp path.  ``cross_attention`` (the
decoder's queries over whisper's encoder context at prefill) is plain
torch ops, as in the reference; at decode the model reads the cross K/V
through ``decode_attention``.

Under a mesh (``repro_torch.dist.sharding``) the tensors are DTensors and
the shard sites are the reference's: queries on heads
(``project_q``), the kv groups that ``flash_attention`` and
``cross_attention`` attend on heads, their outputs on heads.  A kv head
duplicated ``r`` times by the layout (``r > 1`` only when the kv heads do
not divide ``tp``) is expanded to its ``G`` groups before it is sharded,
as the reference's ``expand_kv`` does, so that each rank holds the kv
groups of its own query heads.  ``write_slot`` writes a decode step's K/V
into a cache in place, on each rank's shard of it: a cache sharded on its
slots (kv heads that do not divide ``tp``, the reference's
``cache_axes``) is written only by the rank that holds the slot.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from repro_torch.dist.sharding import (
    current as mesh_ctx,
    is_dtensor,
    pad_to_multiple,
    place,
    shard,
    shard_index,
    shard_map,
    spec_of,
)
from repro_torch.kernels import ops
from repro_torch.models.layers import Norm, dense_init

_DUP_KV: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_duplicate_kv", default=False)


@contextlib.contextmanager
def duplicated_kv(enabled: bool = True):
    """Store kv heads duplicated r x in the weights so they shard on tp
    (train/prefill layout; serving keeps the compact cache layout)."""
    token = _DUP_KV.set(enabled)
    try:
        yield
    finally:
        _DUP_KV.reset(token)


@dataclasses.dataclass(frozen=True)
class HeadLayout:
    h: int          # original q heads
    hp: int         # padded q heads (multiple of tp)
    kv: int         # original kv heads
    kv_store: int   # kv heads held in weights/caches (padded if tp % kv != 0)
    g: int          # group count after duplication (multiple of tp)
    r: int          # duplication factor g // kv_store
    n: int          # q heads per group = hp // g
    d_head: int


def head_layout(n_heads: int, n_kv_heads: int, d_head: int,
                tp: int = 1) -> HeadLayout:
    hp = pad_to_multiple(n_heads, tp)
    if n_kv_heads % tp == 0:
        kv_store, g = n_kv_heads, n_kv_heads
    elif tp % n_kv_heads == 0:
        kv_store, g = n_kv_heads, tp
        # weight-level kv duplication under ``duplicated_kv`` (small r only:
        # weights and cache cost r x)
        if _DUP_KV.get() and tp // n_kv_heads <= 2:
            kv_store = tp
    else:  # e.g. whisper kv=12, tp=16: pad kv alongside q
        kv_store, g = pad_to_multiple(n_kv_heads, tp), pad_to_multiple(n_kv_heads, tp)
    r = g // kv_store
    # q-group correspondence: pad q so hp is a multiple of g
    hp = pad_to_multiple(hp, g)
    return HeadLayout(
        h=n_heads, hp=hp, kv=n_kv_heads, kv_store=kv_store, g=g, r=r,
        n=hp // g, d_head=d_head,
    )


def attn_param_axes(layout: HeadLayout, *, bias: bool = False,
                    qk_norm: bool = False):
    """Logical sharding axes of ``Attention``'s parameters (the
    reference's ``attn_param_axes``): heads on ``tp``, kv heads only when
    they divide it."""
    kv_ax = "tp" if layout.kv_store % mesh_ctx().tp == 0 else None
    p = {
        "wq": (None, "tp", None),
        "wk": (None, kv_ax, None),
        "wv": (None, kv_ax, None),
        "wo": ("tp", None, None),
    }
    if bias:
        p["bq"] = ("tp", None)
        p["bk"] = (kv_ax, None)
        p["bv"] = (kv_ax, None)
    if qk_norm:
        p["q_norm"] = {"scale": (None,)}
        p["k_norm"] = {"scale": (None,)}
    return p


class Attention(nn.Module):
    """Q/K/V/O projections (weights ``wq [d, Hp, Dh]``, ``wk``/``wv``
    ``[d, KVs, Dh]``, ``wo [Hp, Dh, d]``), optional QKV bias and qk-norm,
    initialised as ``repro.models.attention.attn_init``: padded heads are
    zero, biases zero, norm scales one."""

    def __init__(self, d_model: int, layout: HeadLayout, dtype, device,
                 generator, *, bias: bool = False, qk_norm: bool = False):
        super().__init__()
        dh = layout.d_head
        wq = dense_init(d_model, layout.hp * dh, dtype, device, generator)
        wk = dense_init(d_model, layout.kv_store * dh, dtype, device, generator)
        wv = dense_init(d_model, layout.kv_store * dh, dtype, device, generator)
        wo = dense_init(layout.hp * dh, d_model, dtype, device, generator)
        wq = wq.reshape(d_model, layout.hp, dh)
        wk = wk.reshape(d_model, layout.kv_store, dh)
        wv = wv.reshape(d_model, layout.kv_store, dh)
        wo = wo.reshape(layout.hp, dh, d_model)
        if wq.device.type != "meta":
            # zero out padding so padded heads are inert
            wq[:, layout.h:] = 0
            wo[layout.h:] = 0
            wk[:, layout.kv:] = 0
            wv[:, layout.kv:] = 0
        self.wq, self.wk, self.wv, self.wo = (nn.Parameter(w) for w in
                                              (wq, wk, wv, wo))
        if bias:
            for name, n in (("bq", layout.hp), ("bk", layout.kv_store),
                            ("bv", layout.kv_store)):
                setattr(self, name, nn.Parameter(
                    torch.zeros((n, dh), dtype=dtype, device=device)))
        if qk_norm:
            self.q_norm = Norm("rmsnorm", dh, dtype, device)
            self.k_norm = Norm("rmsnorm", dh, dtype, device)

    def project_q(self, x):
        B, S, d = x.shape
        q = (x @ self.wq.reshape(d, -1)).reshape(B, S, *self.wq.shape[1:])
        if hasattr(self, "bq"):
            q = q + self.bq.to(q.dtype)
        if hasattr(self, "q_norm"):
            q = self.q_norm(q)
        return shard(q, "dp", None, "tp", None)

    def project_kv(self, x):
        B, S, d = x.shape
        k = (x @ self.wk.reshape(d, -1)).reshape(B, S, *self.wk.shape[1:])
        v = (x @ self.wv.reshape(d, -1)).reshape(B, S, *self.wv.shape[1:])
        if hasattr(self, "bk"):
            k = k + self.bk.to(k.dtype)
            v = v + self.bv.to(v.dtype)
        if hasattr(self, "k_norm"):
            k = self.k_norm(k)
        return k, v

    def output_proj(self, o):
        """o: [B, S, Hp, Dh] -> [B, S, d]."""
        B, S = o.shape[:2]
        return o.reshape(B, S, -1) @ self.wo.reshape(-1, self.wo.shape[-1])


def expand_kv(k, layout: HeadLayout):
    """[B, S, KVs, Dh] -> the duplicated group layout [B, S, G, Dh]."""
    if layout.r == 1:
        return k
    B, S, kvs, dh = k.shape
    return k[:, :, :, None].expand(B, S, kvs, layout.r, dh).reshape(
        B, S, kvs * layout.r, dh)


def flash_attention(q, k, v, layout: HeadLayout, *, causal: bool,
                    window: Optional[int] = None):
    """q: [B, S, Hp, Dh]; k, v: [B, S, KVs, Dh].  Returns [B, S, Hp, Dh].

    The reference's q-block loop over static kv slices computes the same
    function; here one kernel call does it (``ops.flash_attention``).
    Query head h reads kv head h // (Hp / KVs) either way, so the
    duplicated kv groups are made (``expand_kv``) only where the layout
    duplicates (``r > 1``, under a mesh whose ``tp`` the kv heads do not
    divide), to shard them with their query heads."""
    kx = shard(expand_kv(k, layout), "dp", None, "tp", None)
    vx = shard(expand_kv(v, layout), "dp", None, "tp", None)
    o = ops.flash_attention(q.transpose(1, 2), kx.transpose(1, 2),
                            vx.transpose(1, 2), causal=causal, window=window)
    return shard(o.transpose(1, 2), "dp", None, "tp", None)


def cross_attention(q, k, v, layout: HeadLayout):
    """Bidirectional attention of q [B, S, Hp, Dh] over an encoder context
    k, v [B, T, KVs, Dh] (whisper's 1,500 frames), any T: the reference's
    single dot (``repro.models.attention.cross_attention``), in plain torch
    ops as the reference leaves it to XLA outside any Pallas kernel (B3
    takes only ``T == S``).  Scores in the inputs' dtype, then float32,
    scaled by 1/sqrt(Dh); softmax in float32; the weights cast back to v's
    dtype for the product with v.  Returns [B, S, Hp, Dh]."""
    if is_dtensor(q):
        # per head: each rank its query heads and their kv groups
        kx = shard(expand_kv(k, layout), "dp", None, "tp", None)
        vx = shard(expand_kv(v, layout), "dp", None, "tp", None)
        spec = spec_of(shard(q, "dp", None, "tp", None))
        return shard_map(lambda *t: cross_attention(*t, layout), mesh_ctx(
            ).mesh, (spec, spec, spec), spec)(q, kx, vx)
    B, S, hp, dh = q.shape
    kvs = k.shape[2]
    qg = q.reshape(B, S, kvs, hp // kvs, dh)
    s = torch.einsum("bqgnd,bsgd->bgnqs", qg, k).float() * (
        1.0 / math.sqrt(dh))
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bgnqs,bsgd->bqgnd", a.to(v.dtype), v)
    return o.reshape(B, S, hp, dh)


def decode_attention(q, k_cache, v_cache, cache_len, cache_positions,
                     layout: HeadLayout, *, window: Optional[int] = None):
    """q: [B, 1, Hp, Dh]; caches: [B, Sc, KVs, Dh].

    ``cache_len`` [B] int32 is the number of valid entries and
    ``cache_positions`` [B, Sc] int32 each slot's absolute position (both
    may be broadcast over the batch; ``model.DecodeStep`` builds them once
    per step).  Invalid or overwritten slots of a ring cache are masked by
    position arithmetic, so slot order never matters."""
    B, Sc, kvs, dh = k_cache.shape
    if layout.hp % kvs:
        raise ValueError(f"{layout.hp} query heads do not group onto {kvs}")
    o = ops.decode_attention(q[:, 0], k_cache.transpose(1, 2),
                             v_cache.transpose(1, 2), cache_len,
                             cache_positions, window=window)
    return o.reshape(B, 1, layout.hp, dh)



def write_slot(cache, new, idx) -> None:
    """Write ``new`` [B, 1, KVs, Dh] into slot ``idx`` ([1] int64, a device
    tensor) of ``cache`` [B, Sc, KVs, Dh], in place.  A DTensor cache is
    written shard by shard, ``new`` laid out as the cache is: on a cache
    sharded on its slots, the rank that holds slot ``idx`` writes it and
    every other rank writes back what it holds (no host sync, no branch
    on the slot)."""
    if not is_dtensor(cache):
        cache.index_copy_(1, idx, new.to(cache.dtype))
        return
    spec = spec_of(cache)
    local = cache.to_local()
    val = place(new.to(cache.dtype), (spec[0], None) + spec[2:]).to_local()
    if spec[1] is None:
        local.index_copy_(1, idx, val)
        return
    n = local.shape[1]
    lo = idx - shard_index(spec[1]) * n
    mine = (lo >= 0) & (lo < n)
    at = lo.clamp(0, n - 1)
    local.index_copy_(1, at, torch.where(mine, val,
                                         local.index_select(1, at)))
