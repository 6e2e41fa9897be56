"""The kernels the models call: the twin of ``src/repro/kernels/ops.py``.

On the card each call launches the port's CUDA kernel; on the CPU (tests,
``--device cpu``) the wrapper computes the kernel's plain version.  The
choice follows the device of the tensors, with no switch, as the JAX
package's ``ops`` picks its Pallas kernel on a TPU and its oracle
elsewhere.

Under a mesh the inputs are DTensors, for which DTensor has no sharding
rule of its own: each call runs its kernel on every rank's local shards
(``repro_torch.dist.sharding.shard_map``), and the wrappers see local
shapes.  B3 and B4 (and their autograd Functions) are per head and per
channel: attention runs on each rank's query heads and their kv groups,
the scan on its channels.  B2 runs on the cache as it is laid out: on a
cache sharded on kv heads, each rank attends its heads; on a cache sharded
on its slots, every rank attends all heads over its own slots, and the
partial results are merged across the tensor axis by the log-sum-exps
that B2 returns beside them.  No
region gathers a sharded input in place of running on its shards; an
input that cannot be laid out so raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist.sharding import current as mesh_ctx
from repro_torch.dist.sharding import (
    is_dtensor,
    pmax,
    psum,
    shard_map,
    spec_for,
    spec_of,
)

from repro_torch.kernels.decode_attention import decode_attention_bhd
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn,
    flash_attention_bhsd,
)
from repro_torch.kernels.mamba_scan import MambaScanFn, mamba1_scan


def _tp_axes(entry):
    """The tensor-axis names in a spec entry."""
    axes = () if entry is None else ((entry,) if isinstance(entry, str)
                                     else entry)
    return tuple(a for a in axes if a in mesh_ctx().tp_axes)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None):
    """Prefill and training attention (B3): see ``flash_attention_bhsd``;
    through ``FlashAttentionFn`` (its backward kernels) when an input
    requires a gradient."""
    if is_dtensor(q):
        # q [B, H, S, D] and the kv groups [B, G, S, D] on heads
        spec = spec_for(q.shape, "dp", "tp")
        return shard_map(lambda *t: flash_attention(
            *t, causal=causal, window=window), mesh_ctx().mesh,
            (spec, spec, spec), spec)(q, k, v)
    if _needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    return flash_attention_bhsd(q, k, v, causal=causal, window=window)


def decode_attention(q, k_cache, v_cache, cache_len, positions, *,
                     window: Optional[int] = None):
    """One-token attention over a cache (B2): see ``decode_attention_bhd``."""
    if is_dtensor(k_cache):
        return _decode_on_shards(q, k_cache, v_cache, cache_len, positions,
                                 window)
    return decode_attention_bhd(q, k_cache, v_cache, cache_len, positions,
                                window=window)


def _decode_on_shards(q, k_cache, v_cache, cache_len, positions, window):
    """B2 on the local shards of a cache laid out [B, KV, S, D] as its
    DTensor placements say (the module docstring)."""
    b, kv, s, _ = spec_of(k_cache)
    mesh = mesh_ctx().mesh
    bspec = (b,)
    if _tp_axes(kv):
        # heads: each rank its query heads over its kv heads
        qs = (b, kv, None)
        return shard_map(lambda *t: decode_attention_bhd(*t, window=window),
                         mesh, (qs, (b, kv, s, None), (b, kv, s, None),
                                bspec, (b, s)), qs)(
            q, k_cache, v_cache, cache_len, positions)
    qs = (b, None, None)
    tp = _tp_axes(s)
    if not tp:
        return shard_map(lambda *t: decode_attention_bhd(*t, window=window),
                         mesh, (qs, (b, None, None, None),
                                (b, None, None, None), bspec, (b, None)),
                         qs)(q, k_cache, v_cache, cache_len, positions)

    def body(q, k, v, clen, pos):
        # this rank's slots, then the log-sum-exp merge across tp
        o, lse = decode_attention_bhd(q, k, v, clen, pos, window=window,
                                      with_lse=True)            # [B, H]
        w = torch.exp(lse - pmax(lse, tp))[..., None]
        return (psum(o.float() * w, tp) / psum(w, tp)).to(q.dtype)

    cs = (b, None, s, None)
    return shard_map(body, mesh, (qs, cs, cs, bspec, (b, s)), qs)(
        q, k_cache, v_cache, cache_len, positions)


def mamba_scan(x, dt, Bt, Ct, A, h0=None, h_out=None):
    """The Mamba-1 selective scan (B4): see ``mamba1_scan``.  Unlike the JAX
    package's ``mamba_scan``, it takes an initial state and returns
    (y, h_last), which ``models.ssm.mamba1_mix`` carries through prefill
    and decode; ``h_out`` is where h_last goes (it may be ``h0``).  When an
    input requires a gradient it runs through ``MambaScanFn`` (its backward
    kernel), which takes no ``h_out``: a cache entry advanced in place
    cannot be differentiated.  DTensor inputs run on each rank's channels
    (``Di`` on the tensor axis)."""
    if is_dtensor(x):
        xs = spec_for(x.shape, "dp", None, "tp")
        bs, cs = (xs[0], None, None), (xs[0], xs[2], None)
        args = [x, dt, Bt, Ct, A]
        specs = [xs, xs, bs, bs, (xs[2], None)]
        for extra in (h0, h_out):
            if extra is not None:
                args.append(extra)
                specs.append(cs)
        has_h0, has_out = h0 is not None, h_out is not None

        def body(x, dt, Bt, Ct, A, *rest):
            rest = list(rest)
            h0_ = rest.pop(0) if has_h0 else None
            out_ = rest.pop(0) if has_out else None
            return mamba_scan(x, dt, Bt, Ct, A, h0_, out_)
        return shard_map(body, mesh_ctx().mesh, tuple(specs), (xs, cs))(
            *args)
    if _needs_grad(x, dt, Bt, Ct, A, h0):
        if h_out is not None:
            raise ValueError("the scan cannot write h_out in place when a "
                             "gradient is required")
        return MambaScanFn.apply(x, dt, Bt, Ct, A, h0)
    return mamba1_scan(x, dt, Bt, Ct, A, h0, h_out)
