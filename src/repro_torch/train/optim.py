"""AdamW from scratch with ZeRO-1-style state sharding: the port of
``src/repro/train/optim.py``, term for term.

The state keeps a float32 master copy of every parameter and float32
first and second moments.  ``apply_updates`` clips the gradients by their
global norm, takes one bias-corrected AdamW step in the master domain,
with decoupled weight decay on matrix-like parameters only (``ndim >=
2`` in the reference's tree, ``leaf_ndim``), and casts the working
parameters (bf16 in a bf16 model) from the new master.  This is not
``torch.optim.AdamW``, which decays every tensor and keeps no master
copy.

Trees are dicts of tensors keyed by parameter name (``dict(model.
named_parameters())``).  Unlike the reference, whose arrays are
immutable, the update runs in place, with ``torch._foreach_*`` ops over
all tensors at once: the master, the moments and the working parameters
are overwritten (so a step allocates no second copy of the state), and
the updated trees are returned.  The step count, learning rate and
norms stay on the tensors' device: no value is read back to the host.

ZeRO-1: with an active mesh, ``zero1_shardings`` folds the data axes
into each parameter's spec (the largest unsharded dimension they divide),
and the float32 master and moments live in that layout as DTensors
(``init_opt_state(..., shardings=)``).  ``apply_updates(...,
param_shardings=)`` then updates each rank's slice, casts the new master
to the parameters' dtype in that layout, and only then gathers it into
the parameters' own layout, so that the all-gather moves the parameters'
dtype (bf16), not float32: the order the reference's optimization barrier
keeps.  Sharding trees here are ``{parameter name: spec}``
(``repro_torch.models.model.port_specs`` makes them from the reference's
trees).  With no mesh, or ``dp == 1``, the sharding functions return their
input, as the reference's do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.dist.sharding import current as mesh_ctx
from repro_torch.dist.sharding import place, replicated_inputs, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 200
    decay_steps: int = 10_000
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    master: Any             # float32 master params
    m: Any                  # float32, like params
    v: Any                  # float32, like params


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr_peak``, then a cosine to ``lr_min`` at
    ``decay_steps``; float32, on ``step``'s device."""
    step = step.to(torch.float32)
    warm = cfg.lr_peak * torch.clamp(step / max(cfg.warmup_steps, 1),
                                     max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Dict[str, torch.Tensor],
                   shardings: Optional[Dict[str, Any]] = None) -> OptState:
    """Step 0, float32 master copies and zero moments on the parameters'
    devices; with ``shardings`` ({name: spec}, ``zero1_shardings``) the
    master and moments are laid out by them (each rank keeps its slice of
    its parameters: no communication)."""
    device = next(iter(params.values())).device
    master = {}
    for k, p in params.items():
        t = p.detach().to(torch.float32, copy=True)
        spec = shardings.get(k) if shardings else None
        master[k] = t if spec is None else place(t, spec)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    master=master,
                    m={k: torch.zeros_like(t) for k, t in master.items()},
                    v={k: torch.zeros_like(t) for k, t in master.items()})


def leaf_ndim(name: str, param: torch.Tensor) -> int:
    """The rank of ``param``'s leaf in the reference's tree: a stage's
    period parameter (``stages.<stage>.<p>.…``) is one slice of a leaf
    stacked over the periods, whose rank counts the period axis (so a
    stage's norm scales and biases decay there, as matrices)."""
    return param.dim() + (1 if name.startswith("stages.") else 0)


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state: OptState,
                  cfg: AdamWConfig, param_shardings=None):
    """One AdamW step in the float32 master domain, in place.

    Returns (params, new state, {"lr", "grad_norm"}): ``params``' tensors
    hold the new master cast to their dtype; the state's master, m and v
    are the same tensors, updated, and its step the old step + 1.  The
    grad norm is measured before clipping.  ``param_shardings``
    ({name: spec}): the parameters' own layout, into which the new values
    are gathered after the cast (module docstring)."""
    with replicated_inputs():
        return _apply_updates(params, grads, state, cfg, param_shardings)


def _apply_updates(params, grads, state, cfg, param_shardings):
    keys = list(params)
    step = state.step + 1
    lr = lr_at(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=stepf.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=stepf.device), stepf)

    g = torch._foreach_mul([grads[k].to(torch.float32) for k in keys], scale)
    m = [state.m[k] for k in keys]
    v = [state.v[k] for k in keys]
    mp = [state.master[k] for k in keys]
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g),
                                              1 - b2))
    denom = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    upd = torch._foreach_div(m, c1)
    torch._foreach_div_(upd, denom)
    # decoupled weight decay on matrix-like params only
    mats = [i for i, k in enumerate(keys) if leaf_ndim(k, params[k]) >= 2]
    if mats and cfg.weight_decay:
        torch._foreach_add_([upd[i] for i in mats],
                            torch._foreach_mul([mp[i] for i in mats],
                                               cfg.weight_decay))
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(mp, upd)
    for k, master in zip(keys, mp):
        new = master.to(params[k].dtype)            # in the master's layout
        spec = (param_shardings or {}).get(k)
        params[k].copy_(new if spec is None else place(new, spec))
    return params, OptState(step, state.master, state.m, state.v), {
        "lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# sharding of optimizer state (ZeRO-1 flavour)
# ---------------------------------------------------------------------------


def opt_state_shardings(param_shardings):
    """m/v shard like the params (the reference folds the data axis in at
    leaf level, ``zero1_shardings``); the step is a replicated scalar
    (spec ``()``), or None with no mesh."""
    step = () if mesh_ctx().active else None
    return OptState(step=step, master=None, m=param_shardings,
                    v=param_shardings)


def zero1_shardings(param_shardings, params_shape):
    """Per leaf, the data axes folded into the largest unsharded dimension
    that ``dp`` divides (the reference's ``zero1_shardings``): specs of
    nested dicts, and ``params_shape`` the same tree of shapes (or
    tensors).  With no mesh, or ``dp == 1``, the input unchanged."""
    ctx = mesh_ctx()
    if not ctx.active or ctx.dp <= 1:
        return param_shardings
    dp_axes, dp = ctx.dp_axes, ctx.dp

    def fold(spec, leaf):
        if spec is None:
            return None
        shape = tuple(getattr(leaf, "shape", leaf))
        spec = list(spec) + [None] * (len(shape) - len(spec))
        used = {a for e in spec if e for a in
                ((e,) if isinstance(e, str) else e)}
        if any(a in used for a in dp_axes):
            return tuple(spec)
        best, best_size = None, 0
        for i, (e, n) in enumerate(zip(spec, shape)):
            if e is None and n % dp == 0 and n > best_size:
                best, best_size = i, n
        if best is not None:
            spec[best] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
        return tuple(spec)

    return tree_map(fold, param_shardings, params_shape)
