"""State-space blocks, Mamba-1 (falcon-mamba) and Mamba-2 / SSD (zamba2):
the port of ``src/repro/models/ssm.py``, with its names; and, port-only,
Mamba-2 as published (granite-4.0-h: ``Mamba2``, ``mamba2_block``).

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
zamba2's Mamba-2 runs the reference's chunked SSD as torch einsums, with
no kernel (the JAX package has none for it); its three-operand einsums are
split into two-operand ones, which sum in another order.  Decode is the
same mix at S = 1 from the carried ``(conv, ssm)`` state.

The published Mamba-2 (``configs.base.Mamba2Config``; the paper's block,
of which zamba2's is the JAX package's simplification) projects
``[z, x || B || C, dt]`` from the block input in one product, runs the
causal conv with its bias over all of ``x || B || C`` (B and C in
``n_groups`` groups that the heads share), the SSD in chunks of the
configured length (``ssd``: a ragged tail is padded with ``dt = 0``, which
neither decays nor adds to the state), ``y + D x``, then
``RMSNorm(y * silu(z))`` and the output product.  ``ssd`` runs the
hand-written kernel (``kernels/ssd.py``, ``csrc/ssd_chunk.cu``: the same
float32 products, the running sums compensated and the decays kept on
chip) for tensors on the card, and refuses there what the kernel does
not take: other sizes, x, B and C in another type than bf16, and a call
that needs a gradient (the kernel has no backward); on the CPU it runs
``ssd_reference``, torch products over float32 decay matrices.  Its decode
step (``mamba2_step``) is the recurrence itself, in place on the carried
``(conv, ssm)`` state.  ``MAMBA2_COUNTS`` counts its mixer calls, the SSD
chunks they ran and the calls whose SSD took the kernel (a captured
graph's replays run no Python and count nothing).  It runs on one card,
with no mesh.

Under a mesh the channels (``d_inner``; Mamba-2's heads) lie on the
tensor axis, as in the reference (``ssm_param_axes``).  The projections
are DTensor products; the regions that act per channel run on each
rank's channels (``shard_map``): the causal conv, Mamba-1's scan (in
``kernels.ops``) and Mamba-2's whole SSD, whose ``cumsum`` runs along time
within a head.  No region gathers the channels.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import Mamba2Config, SSMConfig
from repro_torch.dist.sharding import current as mesh_ctx
from repro_torch.dist.sharding import (
    is_dtensor,
    shard,
    shard_map,
    spec_for,
)
from repro_torch.kernels import ops
from repro_torch.kernels import ssd as ssd_kernel
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

    @property
    def conv_dim(self) -> int:
        """Channels of the causal conv and its carried state."""
        return self.d_inner


@dataclasses.dataclass(frozen=True)
class Mamba2Dims(SSMDims):
    """The published Mamba-2's sizes: B and C in ``groups`` groups, which
    the conv runs over beside x."""
    groups: int = 1

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.groups * self.d_state


def ssm_dims(cfg: SSMConfig, d_model: int) -> SSMDims:
    """The block's sizes: ``Mamba2Dims`` for the published Mamba-2
    (``Mamba2Config``), else the reference's ``SSMDims``."""
    d_inner = cfg.expand * d_model
    dt_rank = cfg.dt_rank or -(-d_model // 16)
    extra = ({"groups": cfg.n_groups} if isinstance(cfg, Mamba2Config)
             else {})
    return (Mamba2Dims if extra else SSMDims)(
        version=cfg.version,
        d_model=d_model,
        d_inner=d_inner,
        d_state=cfg.d_state,
        d_conv=cfg.d_conv,
        dt_rank=dt_rank,
        n_heads=d_inner // cfg.head_dim,
        head_dim=cfg.head_dim,
        chunk=cfg.chunk,
        **extra,
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
    return {"conv": torch.empty((batch, dims.d_conv - 1, dims.conv_dim),
                                dtype=dtype, device="meta"),
            "ssm": torch.empty(ssm, dtype=torch.float32, device="meta")}


# ---------------------------------------------------------------------------
# mamba-2 as published (port-only)
# ---------------------------------------------------------------------------


# the published block's mixer calls, the SSD chunks they ran and the calls
# whose SSD took the kernel
MAMBA2_COUNTS = {"calls": 0, "chunks": 0, "kernel_calls": 0}

# elements of one head block's [B, chunks, heads, T, T] decay matrix at
# most (1 GiB in float32): ``ssd_reference`` runs the heads in blocks under it
SSD_BLOCK_ELEMENTS = 1 << 28


def _uniform(shape, lo: float, hi: float, device, generator):
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       dtype=torch.float32, device=device)


class Mamba2(nn.Module):
    """The published block's weights: ``w_in [d, 2 di + 2 G n + nh]`` (z,
    then x || B || C, then dt), ``conv_w [K, di + 2 G n]``, ``conv_b``,
    ``norm [di]`` (the gated RMSNorm's scale) and ``w_out [di, d]`` in the
    model's dtype; ``dt_bias``, ``A_log`` and ``D`` ``[nh]`` in float32.
    Drawn as Mamba-2 initialises them: ``A`` uniform in [1, 16], ``dt``
    log-uniform in [0.001, 0.1] through the inverse softplus, unit ``D``
    and norm, the conv's weights and bias uniform in ``[-1/sqrt(K),
    1/sqrt(K)]`` as a conv layer's are, normal dense weights.  ``eps`` is
    the gated RMSNorm's, the model's norm eps."""

    def __init__(self, dims: Mamba2Dims, eps: float, dtype, device,
                 generator):
        super().__init__()
        self.dims, self.eps = dims, eps
        d, di, nh = dims.d_model, dims.d_inner, dims.n_heads
        param = nn.Parameter
        self.w_in = param(dense_init(d, di + dims.conv_dim + nh, dtype,
                                     device, generator))
        bound = dims.d_conv ** -0.5
        self.conv_w = param(_uniform((dims.d_conv, dims.conv_dim), -bound,
                                     bound, device, generator).to(dtype))
        self.conv_b = param(_uniform((dims.conv_dim,), -bound, bound,
                                     device, generator).to(dtype))
        dt = torch.exp(_uniform((nh,), math.log(1e-3), math.log(1e-1),
                                device, generator))
        self.dt_bias = param(dt + torch.log(-torch.expm1(-dt)))
        self.A_log = param(torch.log(_uniform((nh,), 1.0, 16.0, device,
                                              generator)))
        self.D = param(torch.ones(nh, dtype=torch.float32, device=device))
        self.norm = param(torch.ones(di, dtype=dtype, device=device))
        self.w_out = param(dense_init(di, d, dtype, device, generator))

    def params(self) -> dict:
        return dict(self.named_parameters(recurse=False))

    def forward(self, x, state: Optional[dict] = None, *,
                in_place: bool = False):
        """A prefill (``state`` None, or a state to go on from), or with
        ``in_place`` one decode step that overwrites ``state``."""
        if in_place:
            return mamba2_step(self.params(), x, self.dims, self.eps, state)
        return mamba2_block(self.params(), x, self.dims, self.eps, state)


def _split_in(params: Mapping, x, dims: Mamba2Dims):
    """The input product cut into z [B, S, di], x || B || C [B, S, conv_dim]
    and dt [B, S, nh]."""
    return (x @ params["w_in"]).split(
        [dims.d_inner, dims.conv_dim, dims.n_heads], dim=-1)


def _heads_of(t, dims: Mamba2Dims):
    """B or C [B, S, G n] -> each head's group, [B, S, nh, n] float32."""
    B, S = t.shape[:2]
    t = t.float().view(B, S, dims.groups, dims.d_state)
    return t.repeat_interleave(dims.n_heads // dims.groups, dim=2)


def _gated_norm(y, z, params: Mapping, dims: Mamba2Dims, eps: float,
                dtype):
    """RMSNorm(y * silu(z)) over each group's channels, in float32, cast
    to ``dtype`` before the scale (the published gated norm)."""
    B, S, di = y.shape
    h = (y.float() * F.silu(z.float())).view(B, S, dims.groups, -1)
    h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + eps)
    return h.view(B, S, di).to(dtype) * params["norm"].to(dtype)


def ssd(x, dt, A, Bg, Cg, chunk: int, h0=None):
    """The SSD in chunks of ``chunk`` positions.  x [B, S, nh, hd] and
    Bg, Cg [B, S, G, n] (head h reads group ``h // (nh / G)``) in the
    model's type, dt [B, S, nh] (after the softplus) and A [nh] (< 0)
    float32, h0 [B, nh, hd, n] float32 or None.  Returns (y [B, S, nh, hd]
    without the D term, h_last [B, nh, hd, n]), float32: from the kernel on
    the card, which raises on sizes it does not take and on a call that
    needs a gradient (it has no backward), and from ``ssd_reference`` on
    the CPU."""
    if not x.is_cuda:
        return ssd_reference(x, dt, A, Bg, Cg, chunk, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bg, Cg, h0)):
        raise RuntimeError("the SSD kernel has no backward: run the card's "
                           "Mamba-2 prefill under torch.no_grad()")
    out = ssd_kernel.ssd_chunk(x, dt, A, Bg, Cg, chunk, h0)
    MAMBA2_COUNTS["kernel_calls"] += 1
    return out


def ssd_reference(x, dt, A, Bg, Cg, chunk: int, h0=None):
    """``ssd`` as torch products: all chunks at once, the heads in blocks
    of at most ``SSD_BLOCK_ELEMENTS`` decay entries (a head's state never
    meets another head's, so each block runs whole), x, Bg and Cg taken to
    float32 (exactly, from bf16) or kept in a wider type.  ``C_t . B_s`` is
    computed once a group and broadcast over its heads.  The plain version
    the kernel is held to, and the path everywhere else."""
    x, Bg, Cg = (t.to(torch.promote_types(t.dtype, torch.float32))
                 for t in (x, Bg, Cg))
    Bsz, S, nh, hd = x.shape
    G, n = Bg.shape[2:]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        # dt = 0: no decay and nothing added, so the state passes through
        x, dt, Bg, Cg = (F.pad(t, (0,) * (2 * t.dim() - 4) + (0, pad))
                         for t in (x, dt, Bg, Cg))
    T = chunk
    # [B, nh, nc, T] log-decays and their running sums within a chunk
    cum = torch.cumsum((dt * A).view(Bsz, nc, T, nh).permute(0, 3, 1, 2),
                       dim=-1)
    bg = Bg.reshape(Bsz, nc, T, G, n).permute(0, 3, 1, 2, 4)   # [B,G,nc,T,n]
    cg = Cg.reshape(Bsz, nc, T, G, n).permute(0, 3, 1, 2, 4)
    cb = cg @ bg.transpose(-1, -2)                             # [B,G,nc,T,T]
    group = torch.arange(nh, device=x.device) // (nh // G)

    def heads(t, sl):
        """``t`` [B, G, ...] for the heads of ``sl`` (broadcast for G 1)."""
        return t if G == 1 else t.index_select(1, group[sl])

    tri = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
    tri_c = torch.ones((nc + 1, nc + 1), dtype=torch.bool,
                       device=x.device).tril()
    y = torch.empty((Bsz, nc, T, nh, hd), dtype=x.dtype, device=x.device)
    h_last = torch.empty((Bsz, nh, hd, n), dtype=x.dtype, device=x.device)
    step = max(1, SSD_BLOCK_ELEMENTS // (Bsz * nc * T * T))
    for h in range(0, nh, step):
        sl = slice(h, h + step)
        hb = min(step, nh - h)
        c = cum[:, sl]                                         # [B,hb,nc,T]
        xdt = (x[:, :, sl] * dt[:, :, sl, None]).view(
            Bsz, nc, T, hb, hd).permute(0, 3, 1, 2, 4)         # [B,hb,nc,T,hd]
        # within a chunk: y_t = sum_{s<=t} C_t.B_s exp(cum_t - cum_s) x_s dt_s
        decay = (c[..., :, None] - c[..., None, :]).masked_fill_(
            ~tri, float("-inf")).exp_().mul_(heads(cb, sl))   # [B,hb,nc,T,T]
        yb = decay @ xdt                                       # [B,hb,nc,T,hd]
        del decay
        # each chunk's own end state: sum_s exp(cum_T - cum_s) B_s x_s dt_s
        w = torch.exp(c[..., -1:] - c)                         # [B,hb,nc,T]
        st = (xdt * w[..., None]).transpose(-1, -2) @ heads(bg, sl)
        # between chunks: the state entering each chunk, and the last one
        start = (torch.zeros((Bsz, hb, hd, n), dtype=x.dtype,
                             device=x.device) if h0 is None else h0[:, sl])
        every = torch.cat([start[:, :, None], st], dim=2)      # [B,hb,nc+1,hd,n]
        total = F.pad(c[..., -1], (1, 0)).cumsum(-1)           # [B,hb,nc+1]
        carry = (total[..., :, None] - total[..., None, :]).masked_fill_(
            ~tri_c, float("-inf")).exp_()                      # [B,hb,nc+1,nc+1]
        entering = (carry @ every.flatten(-2)).view(Bsz, hb, nc + 1, hd, n)
        yb += (heads(cg, sl) @ entering[:, :, :nc].transpose(-1, -2)
               ) * torch.exp(c)[..., None]
        y[:, :, :, sl] = yb.permute(0, 2, 3, 1, 4)
        h_last[:, sl] = entering[:, :, nc]
    return y.view(Bsz, nc * T, nh, hd)[:, :S], h_last


def mamba2_block(params: Mapping, x, dims: Mamba2Dims, eps: float,
                 state: Optional[dict] = None):
    """x [B, S, d] -> (y [B, S, d], {conv, ssm}): the published block over
    a whole sequence, from ``state`` or from zero; the states are where
    the sequence leaves them."""
    B, S, _ = x.shape
    nh, hd = dims.n_heads, dims.head_dim
    z, xbc, dt = _split_in(params, x, dims)
    xbc, conv = causal_conv(xbc, params["conv_w"], params["conv_b"],
                            state["conv"] if state is not None else None)
    xs, b, c = xbc.split([dims.d_inner, dims.groups * dims.d_state,
                          dims.groups * dims.d_state], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())
    # the conv's output as it is: ``D xh`` below is taken in float32
    xh = xs.reshape(B, S, nh, hd)
    y, h = ssd(xh, dt, A, b.view(B, S, dims.groups, dims.d_state),
               c.view(B, S, dims.groups, dims.d_state), dims.chunk,
               state["ssm"] if state is not None else None)
    MAMBA2_COUNTS["calls"] += 1
    MAMBA2_COUNTS["chunks"] += -(-S // dims.chunk)
    y = (y + params["D"][:, None] * xh).reshape(B, S, dims.d_inner)
    y = _gated_norm(y, z, params, dims, eps, x.dtype)
    # the conv state is a view of the conv's whole padded input: a copy,
    # so that the cache does not keep that alive
    return y @ params["w_out"], {"conv": conv.clone(), "ssm": h}


def mamba2_step(params: Mapping, x, dims: Mamba2Dims, eps: float,
                state: dict):
    """One decode step, x [B, 1, d]: the conv over the carried inputs and
    ``h <- exp(dt A) h + dt x B``, ``y = C h + D x``, writing the new conv
    inputs and ``h`` into ``state``'s tensors.  Returns (y [B, 1, d],
    state)."""
    B = x.shape[0]
    nh, hd = dims.n_heads, dims.head_dim
    z, xbc, dt = _split_in(params, x, dims)
    xbc, conv = causal_conv(xbc, params["conv_w"], params["conv_b"],
                            state["conv"])
    state["conv"].copy_(conv)
    xs, b, c = xbc.split([dims.d_inner, dims.groups * dims.d_state,
                          dims.groups * dims.d_state], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])[:, 0]       # [B, nh]
    A = -torch.exp(params["A_log"].float())
    xh = xs.reshape(B, nh, hd).float()
    h = state["ssm"]                                            # [B,nh,hd,n]
    h.mul_(torch.exp(dt * A)[..., None, None]).add_(
        (xh * dt[..., None])[..., None] * _heads_of(b, dims)[:, 0, :, None])
    y = (h @ _heads_of(c, dims)[:, 0, :, :, None])[..., 0]      # [B,nh,hd]
    MAMBA2_COUNTS["calls"] += 1
    y = (y + params["D"][:, None] * xh).reshape(B, 1, dims.d_inner)
    y = _gated_norm(y, z, params, dims, eps, x.dtype)
    return y @ params["w_out"], state
