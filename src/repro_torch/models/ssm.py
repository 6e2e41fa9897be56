"""State-space blocks, Mamba-1 (falcon-mamba) and Mamba-2 / SSD (zamba2):
the port of ``src/repro/models/ssm.py``, with its names.

``Mamba`` holds a block's weights under ``ssm_init``'s names; the
functions take them as a mapping (``Mamba.params()``, or the reference's
tree carried across by the tests).  dtypes follow the reference: the
projections, ``conv_w`` and ``conv_b`` in the config dtype; ``D``,
``dt_bias`` and ``A_log`` in float32 whatever that dtype is; the scan's
``dt``, ``B_t`` and ``C_t`` in float32; a block's output in the config
dtype.

Mamba-1 runs its selective scan through ``repro_torch.kernels.ops``
(``mamba_scan``: B4 on the card, its plain version on the CPU), where the
reference runs a chunked associative scan that computes the same
function; the kernel carries the state in and out, so prefill fills the
cache and decode steps it with the same call; in training it runs
through ``MambaScanFn``, whose backward pass is B4's backward kernel.
Mamba-2 runs the
reference's chunked SSD as torch einsums, with no kernel (the JAX package
has none for it); its three-operand einsums are split into two-operand
ones, which sum in another order.  Decode is the same mix at S = 1 from
the carried ``(conv, ssm)`` state.

Under a mesh the channels (``d_inner``; Mamba-2's heads) lie on the
tensor axis, as in the reference (``ssm_param_axes``).  The projections
are DTensor products; the regions that act per channel run on each
rank's channels (``shard_map``): the causal conv, Mamba-1's scan (in
``kernels.ops``) and Mamba-2's whole SSD, whose ``cumsum`` runs along time
within a head.  No region gathers the channels.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import SSMConfig
from repro_torch.dist.sharding import current as mesh_ctx
from repro_torch.dist.sharding import (
    is_dtensor,
    shard,
    shard_map,
    spec_for,
)
from repro_torch.kernels import ops
from repro_torch.models.layers import _normal, dense_init


@dataclasses.dataclass(frozen=True)
class SSMDims:
    version: int
    d_model: int
    d_inner: int
    d_state: int
    d_conv: int
    dt_rank: int          # mamba-1
    n_heads: int          # mamba-2
    head_dim: int         # mamba-2
    chunk: int


def ssm_dims(cfg: SSMConfig, d_model: int) -> SSMDims:
    d_inner = cfg.expand * d_model
    dt_rank = cfg.dt_rank or -(-d_model // 16)
    return SSMDims(
        version=cfg.version,
        d_model=d_model,
        d_inner=d_inner,
        d_state=cfg.d_state,
        d_conv=cfg.d_conv,
        dt_rank=dt_rank,
        n_heads=d_inner // cfg.head_dim,
        head_dim=cfg.head_dim,
        chunk=cfg.chunk,
    )


def _n_chunks(S: int, dims: SSMDims) -> int:
    """The reference's chunk count: the largest of 8, 4, 2 that divides S,
    else 1."""
    for n in (8, 4, 2, 1):
        if S % n == 0:
            return n
    return 1


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def ssm_param_axes(dims: SSMDims):
    """Logical sharding axes of ``Mamba``'s parameters (the reference's
    ``ssm_param_axes``): channels, or Mamba-2's heads, on ``tp``."""
    a = {
        "w_in": (None, "tp"),
        "conv_w": (None, "tp"),
        "conv_b": ("tp",),
        "w_out": ("tp", None),
        "D": ("tp",),
        "dt_bias": ("tp",),
        "A_log": ("tp", None) if dims.version == 1 else ("tp",),
    }
    if dims.version == 1:
        a.update({"w_x": ("tp", None), "w_dt": (None, "tp")})
    else:
        a.update({"w_bc": (None, None), "w_dt_head": (None, "tp")})
    return a


class Mamba(nn.Module):
    """One block's weights, named and shaped as ``ssm_init``'s tree:
    ``w_in [d, 2 di]``, ``conv_w [K, di]``, ``conv_b [di]``,
    ``w_out [di, d]``, ``D``; Mamba-1 adds ``w_x [di, rank + 2n]``,
    ``w_dt [rank, di]``, ``dt_bias [di]``, ``A_log [di, n]``; Mamba-2
    ``w_bc [d, 2n]``, ``w_dt_head [d, nh]``, ``dt_bias [nh]``,
    ``A_log [nh]``.  Drawn as the reference draws them (normal dense
    weights, ``conv_w`` at 0.2, zero biases, unit ``D``, S4D-real
    ``A_log`` for Mamba-1 and ``log(linspace(1, 16, nh))`` for Mamba-2)."""

    def __init__(self, dims: SSMDims, dtype, device, generator):
        super().__init__()
        self.dims = dims
        d, di, n = dims.d_model, dims.d_inner, dims.d_state
        f32, param = torch.float32, nn.Parameter
        self.w_in = param(dense_init(d, 2 * di, dtype, device, generator))
        self.conv_w = param(_normal((dims.d_conv, di), 0.2, dtype, device,
                                    generator))
        self.conv_b = param(torch.zeros(di, dtype=dtype, device=device))
        self.w_out = param(dense_init(di, d, dtype, device, generator))
        heads = di if dims.version == 1 else dims.n_heads
        self.D = param(torch.ones(heads, dtype=f32, device=device))
        if dims.version == 1:
            self.w_x = param(dense_init(di, dims.dt_rank + 2 * n, dtype,
                                        device, generator))
            self.w_dt = param(dense_init(dims.dt_rank, di, dtype, device,
                                         generator))
            self.dt_bias = param(torch.zeros(di, dtype=f32, device=device))
            self.A_log = param(torch.log(torch.arange(
                1, n + 1, dtype=f32, device=device)).expand(di, n).clone())
        else:
            nh = dims.n_heads
            self.w_bc = param(dense_init(d, 2 * n, dtype, device, generator))
            self.w_dt_head = param(dense_init(d, nh, dtype, device,
                                              generator))
            self.dt_bias = param(torch.zeros(nh, dtype=f32, device=device))
            self.A_log = param(torch.log(torch.linspace(
                1.0, 16.0, nh, dtype=f32, device=device)))

    def params(self) -> dict:
        return dict(self.named_parameters(recurse=False))

    def forward(self, x, state: Optional[dict] = None, *,
                in_place: bool = False):
        return mamba_block(self.params(), x, self.dims, state,
                           in_place=in_place)


# ---------------------------------------------------------------------------
# causal depthwise conv (kernel taps unrolled; supports carry state)
# ---------------------------------------------------------------------------


def causal_conv(x, conv_w, conv_b, conv_state=None):
    """x: [B, S, di]; conv_w: [K, di].  Returns (silu(y), new_state
    [B, K-1, di]): the taps summed in float32, in the reference's order.
    DTensor inputs run on each rank's channels."""
    if is_dtensor(x):
        xs = spec_for(x.shape, "dp", None, "tp")
        specs = [xs, (None, xs[2]), (xs[2],)]
        args = [x, conv_w, conv_b]
        if conv_state is not None:
            specs.append(xs)
            args.append(conv_state)
        return shard_map(causal_conv, mesh_ctx().mesh, tuple(specs),
                         (xs, xs))(*args)
    B, S, di = x.shape
    K = conv_w.shape[0]
    if conv_state is None:
        conv_state = x.new_zeros((B, K - 1, di))
    xp = torch.cat([conv_state, x], dim=1)                     # [B, S+K-1, di]
    y = torch.zeros((B, S, di), dtype=torch.float32, device=x.device)
    for t in range(K):
        y = y + xp[:, t:t + S].float() * conv_w[t].float()
    y = (y + conv_b.float()).to(x.dtype)
    return F.silu(y), xp[:, S:]


# ---------------------------------------------------------------------------
# mamba-1 selective scan (B4)
# ---------------------------------------------------------------------------


def mamba1_mix(params: Mapping, x_conv, dims: SSMDims, h0=None, h_out=None):
    """x_conv: [B, S, di] (post-conv, silu'd); h0: [B, di, n] float32 or
    None; h_out: where B4 writes h_last (it may be h0), or None.  Returns
    (y [B, S, di] in x_conv's dtype, h_last [B, di, n])."""
    n, rank = dims.d_state, dims.dt_rank
    A = -torch.exp(params["A_log"].float())                    # [di, n]
    # the product summed over the channels' shards, then sliced
    xbc = shard(x_conv @ params["w_x"], "dp", None, None)  # [B, S, rank+2n]
    dt_low = xbc[..., :rank]
    Bt = xbc[..., rank:rank + n].float()
    Ct = xbc[..., rank + n:].float()
    dt = shard(F.softplus((dt_low @ params["w_dt"]).float()
                          + params["dt_bias"]), "dp", None, "tp")  # [B, S, di]
    xf = x_conv.float()
    y, h = ops.mamba_scan(xf, dt, Bt, Ct, A, h0, h_out)
    y = y + params["D"] * xf
    return y.to(x_conv.dtype), h


# ---------------------------------------------------------------------------
# mamba-2 / SSD (chunked matmul form)
# ---------------------------------------------------------------------------


def mamba2_mix(params: Mapping, x_conv, dims: SSMDims, h0=None, dt_pre=None,
               bc_pre=None):
    """SSD: x_conv [B, S, di] viewed as [B, S, nh, hd]; one decay per head.
    dt_pre [B, S, nh] and bc_pre = (B_t, C_t) [B, S, n] are projected from
    the block input (``mamba_block``), float32.  Returns (y [B, S, di],
    h_last [B, nh, hd, n]).  DTensor inputs run on each rank's heads."""
    if is_dtensor(x_conv):
        xs = spec_for(x_conv.shape, "dp", None, "tp")
        hs = (xs[0], xs[2], None, None)
        specs = [xs, xs, (xs[0], None, None), (xs[0], None, None), (xs[2],),
                 (xs[2],)]
        args = [x_conv, dt_pre, *bc_pre, params["A_log"], params["D"]]
        if h0 is not None:
            specs.append(hs)
            args.append(h0)

        def body(x, dt, Bt, Ct, A_log, D, h=None):
            local = dataclasses.replace(
                dims, d_inner=x.shape[-1], n_heads=dt.shape[-1])
            return mamba2_mix({"A_log": A_log, "D": D}, x, local, h0=h,
                              dt_pre=dt, bc_pre=(Bt, Ct))
        return shard_map(body, mesh_ctx().mesh, tuple(specs), (xs, hs))(
            *args)
    B, S, di = x_conv.shape
    nh, hd, n = dims.n_heads, dims.head_dim, dims.d_state
    xh = x_conv.reshape(B, S, nh, hd)
    dt = dt_pre
    Bt, Ct = bc_pre
    A = -torch.exp(params["A_log"])                            # [nh]
    la = dt * A                                            # [B, S, nh], <= 0
    h = (torch.zeros((B, nh, hd, n), dtype=torch.float32, device=x_conv.device)
         if h0 is None else h0)
    nc = _n_chunks(S, dims)
    T = S // nc
    tri = torch.ones((T, T), dtype=torch.bool, device=x_conv.device).tril()
    ys = []
    for c in range(nc):
        sl = slice(c * T, (c + 1) * T)
        cum = torch.cumsum(la[:, sl], dim=1)                   # [B, T, nh]
        x_c = xh[:, sl].float() * dt[:, sl][..., None]         # [B, T, nh, hd]
        b_c, c_c = Bt[:, sl], Ct[:, sl]                        # [B, T, n]
        # intra-chunk: scores[t, j] = C_t . B_j * exp(cum_t - cum_j), j <= t
        scores = torch.einsum("btn,bjn->btj", c_c, b_c)        # [B, T, T]
        decay = cum[:, :, None, :] - cum[:, None, :, :]        # [B, T, T, nh]
        l_mat = torch.where(tri[None, :, :, None], torch.exp(decay), 0.0)
        y_c = torch.einsum("btjh,bjhd->bthd", scores[..., None] * l_mat, x_c)
        # inter-chunk: the carried state's contribution
        y_c = y_c + (torch.einsum("btn,bhdn->bthd", c_c, h)
                     * torch.exp(cum)[..., None])
        # new carry: h' = exp(cum_T) h + sum_j exp(cum_T - cum_j) B_j x_j
        w = torch.exp(cum[:, -1:, :] - cum)                    # [B, T, nh]
        h = (torch.exp(cum[:, -1])[..., None, None] * h
             + torch.einsum("bjn,bjhd->bhdn", b_c, x_c * w[..., None]))
        ys.append(y_c)
    y = torch.cat(ys, dim=1) if nc > 1 else ys[0]
    y = y + params["D"][:, None] * xh.float()
    return y.reshape(B, S, di).to(x_conv.dtype), h


# ---------------------------------------------------------------------------
# full blocks (norm handled by caller)
# ---------------------------------------------------------------------------


def mamba_block(params: Mapping, x, dims: SSMDims,
                state: Optional[dict] = None, *,
                in_place: bool = False) -> Tuple[torch.Tensor, dict]:
    """x: [B, S, d_model] -> (y, new_state).  ``state`` = {conv, ssm} for
    decode; None for prefill from scratch, which returns the final state
    for the cache.  With ``in_place`` the new states overwrite ``state``'s
    tensors, which are returned (B4 writes the Mamba-1 state there
    itself)."""
    xz = shard(x @ params["w_in"], "dp", None, "tp")
    xs, z = xz.chunk(2, dim=-1)                            # [B, S, di] each
    # the halves on the channels (DTensor re-lays them out: the cut at
    # di does not fall on a shard boundary of 2 di)
    xs, z = shard(xs, "dp", None, "tp"), shard(z, "dp", None, "tp")
    conv_state = state["conv"] if state is not None else None
    ssm_state = state["ssm"] if state is not None else None

    if dims.version == 2:
        # mamba-2 projects dt/B/C from the block input stream
        dt = shard(F.softplus((x @ params["w_dt_head"]).float()
                              + params["dt_bias"]), "dp", None, "tp")
        Bt, Ct = (x @ params["w_bc"]).float().chunk(2, dim=-1)

    x_conv, conv_state = causal_conv(xs, params["conv_w"], params["conv_b"],
                                     conv_state)
    if dims.version == 1:
        y, ssm_state = mamba1_mix(params, x_conv, dims, h0=ssm_state,
                                  h_out=ssm_state if in_place else None)
    else:
        y, ssm_state = mamba2_mix(params, x_conv, dims, h0=ssm_state,
                                  dt_pre=dt, bc_pre=(Bt, Ct))
    y = y * F.silu(z.float()).to(y.dtype)
    new = {"conv": conv_state, "ssm": ssm_state}
    if in_place:
        for name, t in new.items():
            if t is not state[name]:
                state[name].copy_(t)
        new = state
    return y @ params["w_out"], new


def ssm_state_specs(dims: SSMDims, batch: int, dtype):
    """The decode state of one layer as ``meta`` tensors (shape, dtype)."""
    if dims.version == 1:
        ssm = (batch, dims.d_inner, dims.d_state)
    else:
        ssm = (batch, dims.n_heads, dims.head_dim, dims.d_state)
    return {"conv": torch.empty((batch, dims.d_conv - 1, dims.d_inner),
                                dtype=dtype, device="meta"),
            "ssm": torch.empty(ssm, dtype=torch.float32, device="meta")}
