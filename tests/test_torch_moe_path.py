"""Which path ``repro_torch.models.moe._moe_local`` takes, on the CPU.

``_path`` decides it from what the call shows: the device, the grad mode
and the sizes each set of kernels takes (``moe_dispatch.takes``, then
``moe_routed.takes``).  The kernels run only on the card, so each row of
the table holds ``_path`` to its answer for an input that shows the row's
device, grad mode, type and sizes (a stand-in for x with those
attributes, the layer's weights real), and then runs the same layer on
the CPU, where ``PATH_CALLS`` must count the plain path: the CPU and
``meta`` (the dry-run's device) never take the kernels.  The rows: a
gradient to keep, through the weights or the input, takes the plain path;
up to ``MAX_ASSIGNMENTS`` assignments, 64 experts and top-8 the decode
kernels ("fused"), past any of those up to 128 experts and top-16 the
routed kernels; rows not a multiple of 16 bytes, float16, more than 128
experts or more than top-16 the plain path.  On a mesh, ``tp == 1`` runs
``_moe_local`` over the tokens and ``tp == 2`` a ``shard_map`` body,
which counts in ``BODY_CALLS`` and not here.  The card side, where
``PATH_CALLS`` counts the kernels' paths, is
``tests/test_torch_moe_cuda.py``'s.

The wrappers take card tensors only, and refuse what the kernels do not
take before they launch.
"""
from __future__ import annotations

import types

import pytest
import torch

from repro_torch.kernels import moe_dispatch as K
from repro_torch.kernels import moe_routed as R
from repro_torch.models import moe as TMoE


def dims(e: int = 8, k: int = 2, d: int = 64, cf: float = 1.25):
    return TMoE.MoEDims(n_experts=e, e_pad=e, top_k=k, d_model=d, d_ff=32,
                        capacity_factor=cf)


def layer(md, dtype=torch.float32, device="cpu", seed: int = 0):
    return TMoE.MoE(md, dtype, device, torch.Generator().manual_seed(seed))


def params_for(mod, grad: str) -> dict:
    """The layer's weights; detached unless ``grad`` is "weights"."""
    params = dict(mod.named_parameters())
    if grad != "weights":
        params = {k: v.detach() for k, v in params.items()}
    return params


def run(md, n: int, *, grad="off", dtype=torch.float32, device="cpu"):
    """One ``moe_apply`` over ``n`` tokens; returns (the rise of each
    ``PATH_CALLS`` entry, y, aux).  ``grad``: "off" (no_grad), "weights"
    (grad on, weights require it), "input" (grad on, only x requires it),
    "none" (grad on, nothing requires it)."""
    mod = layer(md, dtype, device)
    params = params_for(mod, grad)
    x = torch.randn((1, n, md.d_model),
                    generator=torch.Generator().manual_seed(1)).to(dtype)
    x = x.to(device).requires_grad_(grad == "input")
    before = dict(TMoE.PATH_CALLS)
    with torch.set_grad_enabled(grad != "off"):
        y, aux = TMoE.moe_apply(params, x, md)
    rise = {k: TMoE.PATH_CALLS[k] - before[k] for k in before}
    return rise, y, aux


def path(md, n: int, *, card=True, grad="off", dtype=torch.float32):
    """``_path`` for an input of ``n`` tokens that shows the card (or
    the CPU), ``grad`` as in ``run``, and ``dtype``."""
    params = params_for(layer(md), grad)
    x = types.SimpleNamespace(is_cuda=card, requires_grad=grad == "input",
                              shape=torch.Size((n, md.d_model)), dtype=dtype)
    with torch.set_grad_enabled(grad != "off"):
        return TMoE._path(params, x, md)


ROWS = {
    # name: (dims, tokens, keywords of ``path`` and ``run``, the path on
    # the card)
    "cpu": (dims(), 8, dict(card=False), "gather"),
    "card": (dims(), 8, {}, "fused"),
    "card-bf16": (dims(), 8, dict(dtype=torch.bfloat16), "fused"),
    "grad-weights": (dims(), 8, dict(grad="weights"), "gather"),
    "grad-input": (dims(), 8, dict(grad="input"), "gather"),
    "grad-on-nothing-requires": (dims(), 8, dict(grad="none"), "fused"),
    "assignments-at-limit": (dims(), K.MAX_ASSIGNMENTS // 2, {}, "fused"),
    "assignments-past-limit": (dims(), K.MAX_ASSIGNMENTS // 2 + 1, {},
                               "routed"),
    "assignments-2048": (dims(k=1), 2048, {}, "fused"),
    "assignments-2049": (dims(k=1), 2049, {}, "routed"),
    "experts-64": (dims(e=64, k=8), 16, {}, "fused"),
    "experts-65": (dims(e=65, k=8), 16, {}, "routed"),
    "experts-72": (dims(e=72, k=8), 16, {}, "routed"),
    "experts-128": (dims(e=128, k=8), 16, {}, "routed"),
    "experts-129": (dims(e=129, k=8), 16, {}, "gather"),
    "top-8": (dims(e=16, k=8), 16, {}, "fused"),
    "top-9": (dims(e=16, k=9), 16, {}, "routed"),
    "top-16": (dims(e=16, k=16), 16, {}, "routed"),
    "top-17": (dims(e=32, k=17), 16, {}, "gather"),
    "granite-4.0-h-decode": (dims(e=72, k=10, d=128), 4,
                             dict(dtype=torch.bfloat16), "routed"),
    "routed-grad-weights": (dims(e=72, k=10), 4, dict(grad="weights"),
                            "gather"),
    "row-72-bytes": (dims(d=36), 8, dict(dtype=torch.bfloat16), "gather"),
    "float16": (dims(), 8, dict(dtype=torch.float16), "gather"),
}
PLAIN = {"fused": 0, "gather": 1, "routed": 0}


@pytest.mark.parametrize("name", sorted(ROWS))
def test_path_choice(name):
    md, n, kw, want = ROWS[name]
    assert path(md, n, **kw) == want
    rise, y, aux = run(md, n, **{k: v for k, v in kw.items() if k != "card"})
    assert rise == PLAIN
    assert y.shape == (1, n, md.d_model) and torch.isfinite(aux)


def test_path_choice_on_meta():
    """The dry-run's ``meta`` tensors take the plain path."""
    rise, y, _ = run(dims(), 8, device="meta")
    assert rise == PLAIN and y.device.type == "meta"


@pytest.mark.parametrize("shape,body", [((2, 1), None), ((1, 2), "a2a")])
def test_path_choice_on_a_mesh(shape, body):
    """On a (data, model) mesh of a fake world: ``tp == 1`` runs
    ``_moe_local`` over the tokens, a ``tp == 2`` mesh a body."""
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.mesh import fake_world, make_debug_mesh
    with fake_world(2):
        with use_mesh(make_debug_mesh(shape)):
            bodies = dict(TMoE.BODY_CALLS)
            rise, _, _ = run(dims(), 8)
            moved = {k for k in bodies if TMoE.BODY_CALLS[k] > bodies[k]}
    if body is None:
        assert rise == PLAIN and moved == {"local"}
    else:
        assert rise == dict.fromkeys(PLAIN, 0) and moved == {body}


def dispatch_args(n=8, e=8, k=2, d=64, dtype=torch.bfloat16):
    return [torch.zeros((n, e)), torch.zeros((n, d), dtype=dtype), e, k, 4]


def combine_args(e=8, c=4, d=64, n=8, k=2, dtype=torch.bfloat16):
    return [torch.zeros((e, c, d), dtype=dtype), torch.zeros((e, c)),
            torch.zeros((n, k), dtype=torch.int32)]


WRAPPERS = {
    "dispatch": (K.moe_dispatch, dispatch_args),
    "combine": (K.moe_combine, combine_args),
    "routed-dispatch": (R.moe_routed_dispatch, dispatch_args),
    "routed-combine": (R.moe_routed_combine, combine_args),
}


@pytest.mark.parametrize("which", WRAPPERS)
def test_wrappers_take_only_card_tensors(which):
    fn, args = WRAPPERS[which]
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        fn(*args())


def _edit(args, i, value):
    args[i] = value
    return args


DISPATCH_REFUSED = {
    # name: (arguments, error), refused by both sets' checks; "routed-*"
    # by the routed kernels' alone
    "logits-bf16": (_edit(dispatch_args(), 0,
                          torch.zeros((8, 8), dtype=torch.bfloat16)),
                    TypeError),
    "tokens-differ": (_edit(dispatch_args(), 1,
                            torch.zeros((9, 64), dtype=torch.bfloat16)),
                      ValueError),
    "experts-past-pad": (_edit(dispatch_args(), 2, 9), ValueError),
    "capacity-0": (_edit(dispatch_args(), 4, 0), ValueError),
    "past-assignments": (dispatch_args(n=K.MAX_ASSIGNMENTS // 2 + 1),
                         ValueError),
    "logits-strided": (_edit(dispatch_args(), 0, torch.zeros((8, 16))[:, ::2]),
                       ValueError),
    "routed-experts-129": (dispatch_args(e=129), ValueError),
    "routed-top-17": (dispatch_args(e=32, k=17), ValueError),
    "routed-row-72-bytes": (dispatch_args(d=36), ValueError),
    "routed-slots-past-int32": (_edit(dispatch_args(e=128), 4,
                                      2 ** 31 // 128), ValueError),
    "routed-float16": (dispatch_args(dtype=torch.float16), TypeError),
}


@pytest.mark.parametrize("name", sorted(DISPATCH_REFUSED))
def test_dispatch_check_refuses(name):
    args, error = DISPATCH_REFUSED[name]
    checks = ([R._check_dispatch] if name.startswith("routed-") else
              [K._check_dispatch, R._check_dispatch])
    if name == "past-assignments":      # the routed kernels' to take
        checks = [K._check_dispatch]
    for check in checks:
        with pytest.raises(error):
            check(*args)


COMBINE_REFUSED = {
    "gates-shape": (_edit(combine_args(), 1, torch.zeros((8, 5))),
                    ValueError),
    "slots-int64": (_edit(combine_args(), 2,
                          torch.zeros((8, 2), dtype=torch.long)), TypeError),
    "row-72-bytes": (combine_args(d=36), ValueError),
    "routed-top-17": (combine_args(e=32, k=17), ValueError),
}


@pytest.mark.parametrize("name", sorted(COMBINE_REFUSED))
def test_combine_check_refuses(name):
    args, error = COMBINE_REFUSED[name]
    checks = ([R._check_combine] if name.startswith("routed-") else
              [K._check_combine, R._check_combine])
    for check in checks:
        with pytest.raises(error):
            check(*args)


def test_checks_pass_what_the_kernels_take():
    assert K._check_dispatch(*dispatch_args())
    assert K._check_combine(*combine_args())
    # the routed kernels: past the decode kernels' limits, to theirs
    assert R._check_dispatch(*dispatch_args(n=K.MAX_ASSIGNMENTS))
    assert R._check_dispatch(*dispatch_args(e=128, k=16))
    assert R._check_combine(*combine_args(e=128, k=16))
