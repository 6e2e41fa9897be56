"""Carry the JAX package's weights and caches into the port.

``jax.random`` cannot be reproduced with ``torch.Generator``, so weights
cross from the reference only through here: the tests take the tree of
``repro.models.model.init_params`` as numpy arrays (no JAX needed in this
module) and build the port's ``Model`` with the same numbers.  The
reference stacks each stage's periods on a leading axis; the port's
parameter names are the reference's tree paths with the period index
after the stage name (``dense.layer0.attn.wq[p]`` ->
``stages.dense.<p>.layer0.attn.wq``, whisper's ``encoder`` stage and the
moe layers' ``moe.router``, ``shared_mlp.*`` and ``shared_gate`` alike);
top-level leaves, zamba2's one ``shared_block`` and whisper's
``enc_norm`` among them, keep their path.  Each leaf keeps the port's
dtype (the ssm layers' ``D``, ``dt_bias`` and ``A_log`` and the moe
router are float32 in a bf16 model, as in the reference).  Under an
active mesh the model takes that mesh's layout (heads and experts padded
for its ``tp``), as the reference's tree does when it is built under the
same mesh; ``Model.place_params`` then lays it out.
``params_to_reference`` goes the other way, restacking the periods: the
port's parameters, or their ``.grad``s, as the reference's tree, so that
the tests can compare gradients leaf by leaf with ``jax.grad``'s.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, build_plan


def _leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def params_from_reference(tree: Dict, cfg: ModelConfig, device) -> Model:
    """The port's ``Model`` on ``device`` carrying the weights of the
    reference parameter tree ``tree`` (nested dicts of numpy arrays)."""
    model = Model(cfg, device="meta").to_empty(device=device)
    stages = {s.name for s in build_plan(cfg)}
    want = dict(model.named_parameters())
    seen = set()
    with torch.no_grad():
        for path, arr in _leaves(tree):
            if path[0] in stages:
                names = [".".join(("stages", path[0], str(p)) + path[1:])
                         for p in range(arr.shape[0])]
                parts = list(arr)
            else:
                names, parts = [".".join(path)], [arr]
            for name, part in zip(names, parts):
                if name not in want:
                    raise KeyError(f"reference leaf {name} has no parameter "
                                   f"in the port's model")
                param = want[name]
                if tuple(param.shape) != part.shape:
                    raise ValueError(f"{name}: reference {part.shape}, port "
                                     f"{tuple(param.shape)}")
                # via float32, which holds bf16 leaves exactly
                param.copy_(torch.from_numpy(
                    np.array(part, dtype=np.float32)))
                seen.add(name)
    missing = set(want) - seen
    if missing:
        raise KeyError(f"no reference weights for {sorted(missing)}")
    return model


def params_to_reference(model: Model, *, grads: bool = False) -> Dict:
    """The port's parameters (or, with ``grads``, their gradients; zeros
    where a parameter has none) as the reference's parameter tree: nested
    dicts of float32 numpy arrays, each stage's periods stacked on a
    leading axis, the inverse of ``params_from_reference``."""
    tree: Dict = {}
    periods: Dict[Tuple[str, ...], Dict[int, np.ndarray]] = {}
    for name, param in model.named_parameters():
        t = param.grad if grads else param
        arr = (np.zeros(tuple(param.shape), np.float32) if t is None
               else t.detach().float().cpu().numpy())
        parts = name.split(".")
        if parts[0] == "stages":
            periods.setdefault((parts[1], *parts[3:]), {})[int(parts[2])] = arr
        else:
            _put(tree, parts, arr)
    for path, per in periods.items():
        _put(tree, list(path), np.stack([per[i] for i in range(len(per))]))
    return tree


def _put(tree: Dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def cache_from_reference(tree: Dict, device) -> Dict:
    """A reference cache tree (numpy leaves, leading period axis) as the
    port's cache tree of tensors on ``device``."""
    return {key: (cache_from_reference(val, device) if isinstance(val, dict)
                  else torch.from_numpy(np.array(val)).to(device))
            for key, val in tree.items()}
