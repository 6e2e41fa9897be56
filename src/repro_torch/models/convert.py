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
router are float32 in a bf16 model, as in the reference).  Only the
no-mesh, ``tp = 1`` layout is carried.
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


def cache_from_reference(tree: Dict, device) -> Dict:
    """A reference cache tree (numpy leaves, leading period axis) as the
    port's cache tree of tensors on ``device``."""
    return {key: (cache_from_reference(val, device) if isinstance(val, dict)
                  else torch.from_numpy(np.array(val)).to(device))
            for key, val in tree.items()}
