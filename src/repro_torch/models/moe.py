"""Mixture-of-Experts: the port of ``src/repro/models/moe.py``.

Dispatch is gather-based, as in the reference: route (softmax over the
router's float32 logits, top-k, renormalised gates, the switch aux loss;
the port-only ``MoEConfig.renormalize`` off keeps the top-k probabilities
as they are, as DeepSeek-V2 does),
capacity buckets (the assignments sorted by expert with a stable sort, at
most ``C`` to a bucket, the rest dropped), the experts' swiglu FFN as
batched matrix products over ``[E, C, d]``, then the combine back to token
order.  The batched products are plain matrix products, which the
reference leaves to XLA outside any Pallas kernel; here they are
``torch.bmm``.

Three execution paths share routing, buckets, the experts' FFN and the
combine, as in the reference: ``_moe_local`` with no mesh (and, on a mesh
with ``tp == 1``, on tokens replicated over it); and two ``shard_map``
bodies with the experts on the tensor axis (expert parallelism):
``_moe_a2a_body``, tokens sharded on the sequence over ``"model"``, each
rank's capacity buckets exchanged with an all-to-all so that every rank
runs its own experts over every rank's tokens, and back; and
``_moe_replicated_body`` (decode and short sequences), tokens replicated
over ``"model"``, each rank running its own experts' buckets and the
partial outputs summed.  Both average the aux loss over the mesh.
``moe_apply`` takes the a2a body when ``S % tp == 0 and S >= tp`` and the
batch on the data axes when ``B % dp == 0``.  Experts are zero-padded to
a multiple of the expert-parallel degree (``moe_dims(..., ep)``) and the
padded experts' router logits masked to -1e30, as in the reference.

Nothing here reads a value back to the host: the capacity comes from
shapes (``_capacity``), and routing, buckets and combine are tensor ops of
fixed shapes, so ``Model.decode_multi`` stays on the card.

The combine computes the reference's function by other means.  The
reference scatter-adds every bucket slot into its token's row; on the card
``index_add_`` on floats uses atomics, whose order changes from call to
call, and a bf16 decode step would not repeat bitwise.  Here the slots are
sorted by token with a stable sort, so that a token's slots stay in expert
order (the order of the reference's updates); each token's at most ``k``
slots are gathered into ``[N, k, d]`` (zero rows where a full bucket
dropped an assignment), each scaled by its gate in the experts' dtype as
the reference scales them, and summed over ``k`` with float32
accumulation (``torch.sum``, no atomics), rounded once to the experts'
dtype.  In float32 that differs from the reference only in the order of
``k`` additions.

On the card, with no gradient to keep, two sets of hand-written kernels
take routing, buckets and combine in place of the plain path, around the
same ``_expert_ffn``: the same capacity, drop order, roundings and float32
sum over ``k`` in expert order, each assignment's slot counted instead of
sorted.  The gates may differ from the plain path's in their last bits
(the softmax sums in another order).  ``_path`` takes the first of three
that accepts the call, by what it shows (device, gradient, N, E_pad,
top_k, d, dtype):

* ``"fused"``, decode sizes (``kernels.moe_dispatch``, ``moe_dispatch.
  takes``: at most ``MAX_ASSIGNMENTS`` assignments, 64 experts, top-8): two
  launches, every block routing every token, for latency;
* ``"routed"``, every other such call the kernels take (``kernels.
  moe_routed``, ``moe_routed.takes``: up to 128 experts, top-16, ``E_pad *
  C`` under 2^31): each token routed once across the grid, then the
  buckets filled, in four launches that move each row about once, for
  bytes (prefills, and granite-4.0-h's 72 experts top-10 at any size);
* ``"gather"``, the plain path: training, the ``shard_map`` bodies, the
  CPU and ``meta``, and sizes neither set takes.

``PATH_CALLS`` counts the three.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.dist.sharding import (
    all_to_all,
    axis_index,
    current as mesh_ctx,
    pad_to_multiple,
    place,
    pmean,
    psum,
    shard_map,
)
from repro_torch.kernels import moe_dispatch as moe_kernels
from repro_torch.kernels import moe_routed
from repro_torch.models.layers import _normal, dense_init

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int
    e_pad: int
    top_k: int
    d_model: int
    d_ff: int
    capacity_factor: float
    renormalize: bool = True


def moe_dims(cfg: MoEConfig, d_model: int, ep: int = 1) -> MoEDims:
    """``ep`` is the expert-parallel degree (1 on one card)."""
    return MoEDims(
        n_experts=cfg.n_experts,
        e_pad=pad_to_multiple(cfg.n_experts, ep),
        top_k=cfg.top_k,
        d_model=d_model,
        d_ff=cfg.d_ff_expert,
        capacity_factor=cfg.capacity_factor,
        renormalize=cfg.renormalize,
    )


def moe_param_axes():
    """Logical sharding axes of ``MoE``'s parameters: experts on ``tp``,
    the router replicated."""
    return {
        "router": (None, None),
        "w_gate": ("tp", None, None),
        "w_up": ("tp", None, None),
        "w_down": ("tp", None, None),
    }


class MoE(nn.Module):
    """The experts of one layer: ``router [d, E]``, float32 whatever the
    model's dtype (the reference keeps it float32, so that a bf16 model
    routes in float32), ``w_gate``/``w_up [E, d, f]`` and ``w_down
    [E, f, d]`` in the model's dtype, drawn as
    ``repro.models.moe.moe_init`` shapes them (normal, 1/sqrt(d) in,
    1/sqrt(f) out)."""

    def __init__(self, dims: MoEDims, dtype, device, generator):
        super().__init__()
        self.dims = dims
        E, d, f = dims.e_pad, dims.d_model, dims.d_ff
        self.router = nn.Parameter(dense_init(d, E, torch.float32, device,
                                              generator))
        self.w_gate = nn.Parameter(_normal((E, d, f), 1.0 / math.sqrt(d),
                                           dtype, device, generator))
        self.w_up = nn.Parameter(_normal((E, d, f), 1.0 / math.sqrt(d),
                                         dtype, device, generator))
        self.w_down = nn.Parameter(_normal((E, f, d), 1.0 / math.sqrt(f),
                                           dtype, device, generator))

    def forward(self, x):
        """x: [B, S, d] -> (y [B, S, d], aux loss)."""
        params = {"router": self.router, "w_gate": self.w_gate,
                  "w_up": self.w_up, "w_down": self.w_down}
        return moe_apply(params, x, self.dims)


# ---------------------------------------------------------------------------
# routing + capacity buckets
# ---------------------------------------------------------------------------


def router_probs(router_w, x, dims: MoEDims):
    """x: [N, d] -> the router's probabilities [N, E_pad], float32, padded
    experts at zero."""
    logits = x.float() @ router_w                                # [N, E_pad]
    if dims.e_pad > dims.n_experts:
        pad = torch.arange(dims.e_pad, device=x.device) >= dims.n_experts
        logits = logits.masked_fill(pad, NEG_INF)
    return torch.softmax(logits, dim=-1)


def _route(router_w, x, dims: MoEDims):
    """x: [N, d] -> (gates [N, k] f32, expert_idx [N, k] int64, aux loss).
    The gates are the top-k probabilities over their sum, or as they are
    without ``dims.renormalize``."""
    probs = router_probs(router_w, x, dims)
    gates, idx = torch.topk(probs, dims.top_k, dim=-1)           # [N, k]
    if dims.renormalize:
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # switch-style load-balance aux loss over real experts
    me = probs[:, :dims.n_experts].mean(0)
    # one_hot(idx).sum(1) as a scatter of ones: exact in any order
    picked = torch.zeros_like(probs).scatter_add_(
        1, idx, torch.ones_like(gates))
    ce = picked[:, :dims.n_experts].mean(0) / dims.top_k
    aux = dims.n_experts * (me * ce).sum()
    return gates, idx, aux


def _capacity(n_tokens: int, dims: MoEDims) -> int:
    c = int(n_tokens * dims.top_k * dims.capacity_factor / dims.e_pad) + 1
    return max(4, pad_to_multiple(c, 4))


def _bucket(x, gates, idx, capacity: int, dims: MoEDims):
    """Build capacity buckets.

    Returns xe [E_pad, C, d], ge [E_pad, C] f32, tok [E_pad, C] int64
    (sentinel N for dropped/empty slots).  Which assignments a full bucket
    drops follows the stable order of the sort, as in the reference."""
    N = x.shape[0]
    E, k, C = dims.e_pad, dims.top_k, capacity
    dev = x.device
    flat_e = idx.reshape(-1)                                     # [N*k]
    order = torch.argsort(flat_e, stable=True)
    slot = torch.arange(N * k, device=dev)
    tok_sorted = (slot // k)[order]
    e_sorted = flat_e[order]
    g_sorted = gates.reshape(-1)[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))                      # integers
    starts = torch.cumsum(counts, 0) - counts
    pos = slot - starts[e_sorted]
    keep = pos < C
    # dropped assignments all write row E (slot 0) with the same value,
    # and that row is sliced off
    dst_e = torch.where(keep, e_sorted, E)
    dst_p = torch.where(keep, pos, 0)
    tok = torch.full((E + 1, C), N, dtype=torch.long, device=dev)
    tok[dst_e, dst_p] = torch.where(keep, tok_sorted, N)
    ge = torch.zeros((E + 1, C), dtype=torch.float32, device=dev)
    ge[dst_e, dst_p] = torch.where(keep, g_sorted, 0.0)
    tok, ge = tok[:E], ge[:E]
    x_pad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return x_pad[tok], ge, tok                                   # [E, C, d]


def _expert_ffn(w_gate, w_up, w_down, xe):
    """xe: [E, C, d] -> [E, C, d] (swiglu experts)."""
    g = torch.bmm(xe, w_gate)
    u = torch.bmm(xe, w_up)
    return torch.bmm(F.silu(g) * u, w_down)


def _combine(y_e, ge, tok, n_tokens: int, d: int, top_k: int):
    """Expert outputs back to token order, without atomics (the module
    docstring says how): y_e [E, C, d], ge and tok [E, C] -> [N, d] in
    y_e's dtype.  ``top_k`` bounds a token's slots."""
    E, C = tok.shape
    flat = tok.reshape(-1)                                       # [E*C]
    order = torch.argsort(flat, stable=True)          # by token, then expert
    t_sorted = flat[order]
    rank = (torch.arange(E * C, device=tok.device)
            - torch.searchsorted(t_sorted, t_sorted))   # among a token's slots
    keep = t_sorted < n_tokens
    # empty slots all write row N (rank 0) with the same value, sliced off
    dst_t = torch.where(keep, t_sorted, n_tokens)
    dst_r = torch.where(keep, rank, 0)
    src = torch.full((n_tokens + 1, top_k), E * C, dtype=torch.long,
                     device=tok.device)                 # E*C: a zero row
    src[dst_t, dst_r] = torch.where(keep, order, E * C)
    scaled = (y_e * ge[..., None].to(y_e.dtype)).reshape(E * C, d)
    scaled = torch.cat([scaled, scaled.new_zeros((1, d))])
    return torch.sum(scaled[src[:n_tokens]], dim=1,
                     dtype=torch.float32).to(y_e.dtype)


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------


# which path each ``_moe_local`` call took, counted (a graph's capture
# counts, its replays run no Python); the tests read it
PATH_CALLS = {"fused": 0, "gather": 0, "routed": 0}


def _path(params: Dict[str, torch.Tensor], x, dims: MoEDims) -> str:
    """Which path ``_moe_local`` takes (module docstring): ``"fused"`` or
    ``"routed"`` on the card, with no gradient to keep, at sizes the
    kernels take; ``"gather"`` otherwise."""
    if not x.is_cuda:
        return "gather"
    if torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in params.values())):
        return "gather"
    N, d = x.shape
    if moe_kernels.takes(N, dims.e_pad, dims.top_k, d, x.dtype):
        return "fused"
    if moe_routed.takes(N, dims.e_pad, dims.top_k, d, x.dtype,
                        _capacity(N, dims)):
        return "routed"
    return "gather"


def _moe_kernels(dispatch, combine, params: Dict[str, torch.Tensor], x,
                 dims: MoEDims):
    """``_moe_local`` through a dispatch and a combine kernel around
    ``_expert_ffn``."""
    logits = x.float() @ params["router"]                        # [N, E_pad]
    xe, ge, slots, aux = dispatch(logits, x, dims.n_experts, dims.top_k,
                                  _capacity(x.shape[0], dims),
                                  renormalize=dims.renormalize)
    y_e = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], xe)
    return combine(y_e, ge, slots), aux


def _moe_fused(params: Dict[str, torch.Tensor], x, dims: MoEDims):
    """``_moe_local`` through the decode-sized kernels."""
    return _moe_kernels(moe_kernels.moe_dispatch, moe_kernels.moe_combine,
                        params, x, dims)


def _moe_routed(params: Dict[str, torch.Tensor], x, dims: MoEDims):
    """``_moe_local`` through the route-once-then-fill kernels."""
    return _moe_kernels(moe_routed.moe_routed_dispatch,
                        moe_routed.moe_routed_combine, params, x, dims)


def _moe_gather(params: Dict[str, torch.Tensor], x, dims: MoEDims):
    """``_moe_local`` through the plain path's routing, buckets and
    combine."""
    N, d = x.shape
    gates, idx, aux = _route(params["router"], x, dims)
    C = _capacity(N, dims)
    xe, ge, tok = _bucket(x, gates, idx, C, dims)
    y_e = _expert_ffn(params["w_gate"], params["w_up"], params["w_down"], xe)
    return _combine(y_e, ge, tok, N, d, dims.top_k), aux


_PATHS = {"fused": _moe_fused, "routed": _moe_routed, "gather": _moe_gather}


def _moe_local(params: Dict[str, torch.Tensor], x, dims: MoEDims):
    """x: [N, d] -> (y [N, d], aux)."""
    path = _path(params, x, dims)
    PATH_CALLS[path] += 1
    return _PATHS[path](params, x, dims)


# which body ``moe_apply`` last took under a mesh, counted (the tests read
# it to show that both bodies run)
BODY_CALLS = {"local": 0, "a2a": 0, "replicated": 0}


def _moe_a2a_body(router, w_gate, w_up, w_down, x, dims: MoEDims,
                  axis_names=()):
    """Per rank inside ``shard_map``; x: [b_loc, s_loc, d].  The buckets
    [E_pad, C, d] go out by expert (each rank gets its E_loc experts'
    rows from every rank, [E_loc, tp*C, d]) and come back by rank."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, idx, aux = _route(router, xt, dims)
    C = _capacity(b * s, dims)
    xe, ge, tok = _bucket(xt, gates, idx, C, dims)
    xe = all_to_all(xe, "model", split_axis=0, concat_axis=1)
    y_e = _expert_ffn(w_gate, w_up, w_down, xe)
    y_e = all_to_all(y_e, "model", split_axis=1, concat_axis=0)
    y = _combine(y_e, ge, tok, b * s, d, dims.top_k)
    return y.reshape(b, s, d), pmean(aux, axis_names)


def _moe_replicated_body(router, w_gate, w_up, w_down, x, dims: MoEDims,
                         axis_names=()):
    """Tokens replicated over ``"model"``; each rank runs the buckets of
    its own experts (rows ``rank * e_loc`` on) and the partial outputs are
    summed over ``"model"``."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    gates, idx, aux = _route(router, xt, dims)
    C = _capacity(b * s, dims)
    xe, ge, tok = _bucket(xt, gates, idx, C, dims)
    e_loc = w_gate.shape[0]
    lo = axis_index("model") * e_loc
    y_e = _expert_ffn(w_gate, w_up, w_down, xe[lo:lo + e_loc])
    y = _combine(y_e, ge[lo:lo + e_loc], tok[lo:lo + e_loc], b * s, d,
                 dims.top_k)
    return psum(y, "model").reshape(b, s, d), pmean(aux, axis_names)


def moe_apply(params: Dict[str, torch.Tensor], x,
              dims: MoEDims) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux loss scalar).  No mesh: the local
    path; a mesh: the a2a or the replicated body (module docstring)."""
    ctx = mesh_ctx()
    B, S, d = x.shape
    if not ctx.active:
        y, aux = _moe_local(params, x.reshape(B * S, d), dims)
        return y.reshape(B, S, d), aux
    names = ("router", "w_gate", "w_up", "w_down")
    if ctx.tp == 1:
        # the reference's local path over the global tokens
        BODY_CALLS["local"] += 1

        def local(*a):
            y, aux = _moe_local(dict(zip(names, a[:4])),
                                a[4].reshape(B * S, d), dims)
            return y.reshape(B, S, d), aux
        rep = (None, None, None)
        return shard_map(local, ctx.mesh, ((None, None), rep, rep, rep, rep),
                         (rep, ()))(*(params[n] for n in names), x)
    bspec = (ctx.dp_axes if len(ctx.dp_axes) > 1 else ctx.dp_axes[0]) \
        if B % ctx.dp == 0 and ctx.dp > 1 else None
    seq = S % ctx.tp == 0 and S >= ctx.tp
    body = _moe_a2a_body if seq else _moe_replicated_body
    BODY_CALLS["a2a" if seq else "replicated"] += 1
    w_spec = ("model", None, None)
    xspec = (bspec, "model" if seq else None, None)
    fn = shard_map(
        lambda *a: body(*a, dims=dims,
                        axis_names=tuple(ctx.mesh.mesh_dim_names)),
        ctx.mesh, ((None, None), w_spec, w_spec, w_spec, xspec), (xspec, ()))
    y, aux = fn(*(params[n] for n in names), x)
    # the output back on the residual stream's layout (the reference's
    # constraint at the layer's end, one op later): a gradient sharded on
    # the sequence would reach views that flatten it
    return (place(y, (bspec, None, None)) if seq else y), aux
