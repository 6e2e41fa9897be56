"""Multi-head latent attention (DeepSeek-V2, Liu et al. 2024), port-only:
the JAX package has no such attention.

Per token the layer caches one latent ``c_kv`` of ``R`` values (RMS-normed)
and one rotary key ``k_pe`` of ``Dr`` values that every head shares; each
head's plain key and its value are decompressed from ``c_kv``:

    q = h W_q                          [H, Dn + Dr]: q_nope, q_pe
    [c_kv, k_pe] = h W_kv_a;  c_kv = RMSNorm(c_kv);  rotate q_pe, k_pe
    [k_nope, v] = c_kv W_kv_b          [H, Dn + Dv]
    o = softmax(scale (q_nope . k_nope + q_pe . k_pe)) v;   y = o W_o

``scale`` is ``(Dn + Dr)^-1/2``, times YaRN's ``mscale(factor,
mscale_all_dim)`` squared where the configuration stretches the rotary
(``configs.base.YarnScaling``).  Weights (``MLA``): ``wq [d, H, Dn + Dr]``,
``wkv_a [d, R + Dr]``, ``kv_norm``, ``wkv_b [R, H, Dn + Dv]``, ``wo [H, Dv,
d]``.  The published code pairs rotary channels (2i, 2i + 1); the port's
``layers.rotate`` pairs halves (i, i + Dr / 2), so the rotary columns of
``wq`` and ``wkv_a`` are kept in halves order: ``rope_from_interleaved``
reorders published-layout columns once, when such weights are laid in,
and the scores are the same (both sides of each product permuted alike).

A layer's cache entry is ``{"ckv": [B, Sc, R], "kpe": [B, Sc, Dr]}`` in the
model's dtype: ``c_kv`` after its norm, ``k_pe`` after its rotary,
``R + Dr`` values a token (576 at DeepSeek-V2's widths, where plain K/V
of the same heads would be 16 x (192 + 128)).  Two paths:

* ``MLA.prefill``, decompressed: ``k_nope`` and ``v`` made for every
  token, then B3 (``kernels.ops.flash_attention``), which takes one head
  dim for q, k and v (``decompressed_attention``).  q, k and v are
  zero-padded to the smallest of B3's tensor-core head dims that holds
  ``Dn + Dr`` and ``Dv`` (256 for 192 and 128), the zeros adding nothing
  to the scores or the output, and q is prescaled so that B3's ``1 /
  sqrt(256)`` gives ``scale``.  The padding executes ``2 x 256``
  operations a pair and head for the ``192 + 128`` needed.
* ``MLA.decode``, absorbed: the step's ``c_kv`` and ``k_pe`` written into
  the cache in place, then ``W_kv_b`` folded into the query and the
  output: ``q_lat = q_nope W_uk`` (``R`` a head), scores ``q_lat . c_kv +
  q_pe . k_pe``, ``o_lat = sum_s p_s c_kv_s``, ``o = o_lat W_uv``.  Plain
  batched products over the latent cache, float32 scores and softmax,
  no host sync: ``Model.decode_multi`` captures it in its graph.

``MLA_COUNTS`` counts decompressed and absorbed calls, the latent slots
written (a prefill's ``B x S``, a step's ``B``) and the B3 calls on padded
heads; a captured graph's replays run no Python and count nothing.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import WGMMA_HEAD_DIMS
from repro_torch.models.attention import write_slot
from repro_torch.models.layers import Norm, dense_init, rotate, yarn_mscale

# the tests and the benchmark read these
MLA_COUNTS = {"decompressed": 0, "absorbed": 0, "latent_slots": 0,
              "padded_b3": 0}


@dataclasses.dataclass(frozen=True)
class MLADims:
    d_model: int
    n_heads: int
    kv_rank: int      # R: the latent c_kv
    nope: int         # Dn: a head's plain query and key
    rope: int         # Dr: its rotary query, and the shared rotary key
    v: int            # Dv: a head's value
    scale: float      # the scores' softmax scale
    eps: float        # kv_norm's

    @property
    def qk(self) -> int:
        return self.nope + self.rope


def mla_dims(cfg) -> MLADims:
    """The dims of ``cfg`` (a ``configs.base.MLAConfig``)."""
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    scale = qk ** -0.5
    ys = cfg.rope_scaling
    if ys is not None and ys.mscale_all_dim:
        scale *= yarn_mscale(ys.factor, ys.mscale_all_dim) ** 2
    return MLADims(cfg.d_model, cfg.n_heads, cfg.kv_lora_rank,
                   cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                   cfg.v_head_dim, scale, cfg.norm_eps)


def _rope_order(rope: int) -> torch.Tensor:
    """Channel ``i`` of the halves order is channel ``order[i]`` of the
    interleaved one: (0, 2, ..., rope - 2, 1, 3, ..., rope - 1)."""
    return torch.cat([torch.arange(0, rope, 2), torch.arange(1, rope, 2)])


def rope_from_interleaved(w: torch.Tensor, rope: int) -> torch.Tensor:
    """``w`` with the last ``rope`` entries of its last axis (the rotary
    columns of ``wq [d, H, Dn + Dr]`` or ``wkv_a [d, R + Dr]``) moved from
    the published interleaved order to the halves order ``rotate``
    takes."""
    idx = _rope_order(rope).to(w.device)
    out = w.clone()
    out[..., -rope:] = w[..., -rope:][..., idx]
    return out


def _bmm_f32(a, b):
    """a @ b with float32 results: the card's products keep their float32
    sums (``out_dtype``); elsewhere the inputs are raised first, which
    gives the same products of the same values."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def decompressed_attention(q_nope, q_pe, k_nope, k_pe, v, scale: float):
    """Causal attention of every head's ``[q_nope, q_pe]`` [B, S, H, Dn],
    [B, S, H, Dr] over its ``[k_nope, k_pe]`` (``k_pe`` [B, S, Dr] shared
    by the heads) and ``v`` [B, S, H, Dv], scores scaled by ``scale``, in
    one B3 call (``kernels.ops.flash_attention``) at ``P``, the smallest
    of B3's tensor-core head dims that holds ``Dn + Dr`` and ``Dv``: q, k
    and v zero-padded to it, q prescaled so that B3's ``1 / sqrt(P)``
    gives ``scale``.  Returns o [B, S, H, Dv] in q's dtype (a view)."""
    B, S, H, Dn = q_nope.shape
    Dr, Dv = q_pe.shape[-1], v.shape[-1]
    need = max(Dn + Dr, Dv)
    P = min((p for p in WGMMA_HEAD_DIMS if p >= need), default=need)
    pre = scale * math.sqrt(P)
    q = q_nope.new_zeros(B, S, H, P)
    q[..., :Dn] = q_nope.float() * pre
    q[..., Dn:Dn + Dr] = q_pe.float() * pre
    k = q_nope.new_zeros(B, S, H, P)
    k[..., :Dn] = k_nope
    k[..., Dn:Dn + Dr] = k_pe[:, :, None]
    vp = q_nope.new_zeros(B, S, H, P)
    vp[..., :Dv] = v
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            vp.transpose(1, 2), causal=True)
    MLA_COUNTS["padded_b3"] += P != Dn + Dr or P != Dv
    return o.transpose(1, 2)[..., :Dv]


class MLA(nn.Module):
    """One layer's latent attention (module docstring), weights drawn as a
    dense weight is (normal, 1/sqrt(fan-in)), ``kv_norm``'s scale one."""

    def __init__(self, dims: MLADims, dtype, device, generator):
        super().__init__()
        self.dims = dims
        d, H, R = dims.d_model, dims.n_heads, dims.kv_rank
        self.wq = nn.Parameter(dense_init(d, H * dims.qk, dtype, device,
                                          generator).reshape(d, H, dims.qk))
        self.wkv_a = nn.Parameter(dense_init(d, R + dims.rope, dtype, device,
                                             generator))
        self.kv_norm = Norm("rmsnorm", R, dtype, device, eps=dims.eps)
        self.wkv_b = nn.Parameter(dense_init(
            R, H * (dims.nope + dims.v), dtype, device,
            generator).reshape(R, H, dims.nope + dims.v))
        self.wo = nn.Parameter(dense_init(H * dims.v, d, dtype, device,
                                          generator).reshape(H, dims.v, d))

    def _project(self, h, rot):
        """h [B, S, d] -> (q_nope [B, S, H, Dn], q_pe [B, S, H, Dr] rotated,
        c_kv [B, S, R] normed, k_pe [B, S, Dr] rotated)."""
        B, S, d = h.shape
        dm = self.dims
        q = (h @ self.wq.reshape(d, -1)).view(B, S, dm.n_heads, dm.qk)
        kv_a = h @ self.wkv_a
        ckv = self.kv_norm(kv_a[..., :dm.kv_rank])
        kpe = rotate(kv_a[..., None, dm.kv_rank:], *rot)[:, :, 0]
        return q[..., :dm.nope], rotate(q[..., dm.nope:], *rot), ckv, kpe

    def output(self, o):
        """o [B, S, H, Dv] -> [B, S, d]."""
        B, S = o.shape[:2]
        return o.reshape(B, S, -1) @ self.wo.reshape(-1, self.dims.d_model)

    def prefill(self, h, rot):
        """Decompressed attention over h [B, S, d] (normed), causal, from an
        empty cache.  Returns (y [B, S, d], the entry ``{ckv, kpe}``)."""
        B, S, _ = h.shape
        dm = self.dims
        q_nope, q_pe, ckv, kpe = self._project(h, rot)
        kv = (ckv @ self.wkv_b.reshape(dm.kv_rank, -1)).view(
            B, S, dm.n_heads, dm.nope + dm.v)
        o = decompressed_attention(q_nope, q_pe, kv[..., :dm.nope], kpe,
                                   kv[..., dm.nope:], dm.scale)
        del q_nope, q_pe, kv
        MLA_COUNTS["decompressed"] += 1
        MLA_COUNTS["latent_slots"] += B * S
        return self.output(o), {"ckv": ckv, "kpe": kpe}

    def decode(self, h, rot, entry, step):
        """Absorbed attention of one token h [B, 1, d] (normed) over the
        latent cache ``entry``, into which its ``c_kv`` and ``k_pe`` are
        written at ``step``'s slot first, in place.  Returns y [B, 1, d]."""
        B = h.shape[0]
        dm = self.dims
        q_nope, q_pe, ckv, kpe = self._project(h, rot)
        cc, kc = entry["ckv"], entry["kpe"]
        idx, pos = step.slots(cc.shape[1], False)
        write_slot(cc, ckv, idx)
        write_slot(kc, kpe, idx)
        o = absorbed_attention(q_nope[:, 0], q_pe[:, 0], cc, kc,
                               self.wkv_b, pos >= step.valid[:, None],
                               dm.scale)
        MLA_COUNTS["absorbed"] += 1
        MLA_COUNTS["latent_slots"] += B
        return self.output(o[:, None])


def absorbed_attention(q_nope, q_pe, ckv, kpe, wkv_b, masked, scale: float):
    """One token's attention over the latent cache with ``W_kv_b``
    absorbed: q_nope [B, H, Dn] and q_pe [B, H, Dr] (rotated) over ckv
    [B, Sc, R] and kpe [B, Sc, Dr], ``wkv_b`` [R, H, Dn + Dv], ``masked``
    [B, Sc] true at the slots not attended.  ``q_lat = q_nope W_uk``;
    scores ``(q_lat . c_kv + q_pe . k_pe) scale`` and their softmax in
    float32; ``o = (p c_kv) W_uv``.  Returns o [B, H, Dv] in ckv's
    dtype."""
    nope = q_nope.shape[-1]
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope, w_uk)          # [B, H, R]
    s = (_bmm_f32(q_lat, ckv.transpose(1, 2))
         + _bmm_f32(q_pe, kpe.transpose(1, 2))) * scale
    s = s.masked_fill(masked[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1).to(ckv.dtype)                 # [B, H, Sc]
    o_lat = _bmm_f32(p, ckv).to(ckv.dtype)                     # [B, H, R]
    return torch.einsum("bhr,rhv->bhv", o_lat, w_uv)


def mla_entry_specs(dims: MLADims, batch: int, seq: int, dtype):
    """A layer's cache entry as ``meta`` tensors (no period axis)."""
    return {"ckv": torch.empty((batch, seq, dims.kv_rank), dtype=dtype,
                               device="meta"),
            "kpe": torch.empty((batch, seq, dims.rope), dtype=dtype,
                               device="meta")}


def mla_param_axes():
    """Logical sharding axes of ``MLA``'s parameters: the heads on ``tp``,
    the latent projection and its norm replicated."""
    return {"wq": (None, "tp", None), "wkv_a": (None, None),
            "kv_norm": {"scale": (None,)}, "wkv_b": (None, "tp", None),
            "wo": ("tp", None, None)}
