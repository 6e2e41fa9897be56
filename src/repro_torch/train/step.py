"""The training step: the port of ``src/repro/train/step.py``.

``train_step`` runs ``n_micro`` microbatches through ``Model.loss_fn`` and
``backward``, sums their gradients in float32, divides the sum by
``n_micro``, and takes one AdamW step (``optim.apply_updates``), which
writes the model's parameters in place from the new float32 master.  The
microbatches are split as the reference's ``to_micro`` splits them (the
batch axis, dim 1 for ``mrope_positions`` [3, B, S]); ``ce``, ``aux`` and
``loss`` are the microbatches' means.

On the card, attention (B3) and the Mamba-1 scan (B4) run forward and
backward through the port's kernels (``kernels.ops`` picks their autograd
Functions when a gradient is required).  Under a mesh, with
``grad_shardings`` (the reference's ZeRO-1 tree, ``zero1_shardings``),
each microbatch's gradient is laid out in the ZeRO layout as it comes out
of ``backward`` (from DTensor's partial sums over the data axes: a
reduce-scatter) and only then summed in float32; ``param_shardings`` is
passed on to ``apply_updates``.  A microbatch is each rank's slice of its
own batch shard, so splitting moves no data.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import current as mesh_ctx
from repro_torch.dist.sharding import (
    from_local,
    is_dtensor,
    place,
    replicated_inputs,
    spec_of,
)
from repro_torch.train import optim


def pick_n_micro(cfg: ModelConfig, global_batch: int, seq_len: int,
                 budget_bytes: float = 256e6, cap: int = 8) -> int:
    """Smallest power-of-two microbatch count keeping the per-device
    residual-stream slab under ``budget_bytes``."""
    dp = mesh_ctx().dp
    per_dev = max(global_batch // dp, 1)
    slab = per_dev * seq_len * cfg.d_model * 2  # bf16
    n = 1
    while (slab / n > budget_bytes and n < cap
           and global_batch % (2 * n) == 0
           and global_batch // (2 * n) >= dp):
        n *= 2
    return n


def to_micro(batch: Dict[str, torch.Tensor], n_micro: int) -> list:
    """``batch`` as ``n_micro`` microbatches, split along the batch axis
    (dim 1 of ``mrope_positions`` [3, B, S], dim 0 of everything else)."""
    def split(key, x):
        dim = 1 if key == "mrope_positions" else 0
        if x.shape[dim] % n_micro:
            raise ValueError(f"{key}: batch {x.shape[dim]} does not split "
                             f"into {n_micro} microbatches")
        if is_dtensor(x):
            # each rank's slice of its own shard
            spec = spec_of(x)
            return [from_local(t, spec, x.device_mesh) for t in
                    torch.chunk(x.to_local(), n_micro, dim=dim)]
        return torch.chunk(x, n_micro, dim=dim)
    parts = {k: split(k, v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n_micro)]


def make_train_step(model, ocfg: optim.AdamWConfig, *, n_micro: int = 1,
                    unroll: bool = False, remat: bool = True,
                    ce_chunks: int = 8, grad_shardings=None,
                    param_shardings=None):
    """Builds ``train_step(opt_state, batch) -> (opt_state, metrics)`` for
    ``model`` (a ``repro_torch.models.model.Model``), whose parameters it
    updates in place.  ``batch`` holds tensors on the model's device;
    ``metrics`` are float32 0-d tensors on it (``ce``, ``aux``, ``loss``,
    ``lr``, ``grad_norm``), so a step reads nothing back to the host.
    ``grad_shardings`` / ``param_shardings``: the reference's trees (the
    ZeRO-1 layout and the parameters' own, module docstring)."""
    from repro_torch.models.model import port_specs
    params = dict(model.named_parameters())
    gspec = port_specs(model, grad_shardings) if grad_shardings else {}
    pspec = port_specs(model, param_shardings) if param_shardings else None

    def to_zero(k, g):
        """A gradient in the ZeRO layout (bf16 reduce-scatter), then f32."""
        spec = gspec.get(k)
        return (g if spec is None else place(g, spec)).to(torch.float32)

    def train_step(opt_state: optim.OptState, batch):
        micro = [batch] if n_micro == 1 else to_micro(batch, n_micro)
        gsum: Dict[str, torch.Tensor] = {}
        losses, metrics = [], []
        for b in micro:
            for p in params.values():
                p.grad = None
            loss, m = model.loss_fn(b, remat=remat, unroll=unroll,
                                    ce_chunks=ce_chunks)
            with replicated_inputs():
                loss.backward()
                for k, p in params.items():
                    g = to_zero(k, torch.zeros_like(p) if p.grad is None
                                else p.grad)
                    gsum[k] = g if k not in gsum else gsum[k].add_(g)
            losses.append(loss.detach())
            metrics.append({k: v.detach() for k, v in m.items()})
        for p in params.values():
            p.grad = None
        with replicated_inputs():
            if n_micro > 1:
                for g in gsum.values():
                    g.div_(n_micro)
            loss = torch.stack(losses).mean()
            out = {k: torch.stack([m[k] for m in metrics]).mean()
                   for k in metrics[0]}
        _, new_state, om = optim.apply_updates(params, gsum, opt_state, ocfg,
                                               param_shardings=pspec)
        return new_state, dict(out, loss=loss, **om)

    return train_step
