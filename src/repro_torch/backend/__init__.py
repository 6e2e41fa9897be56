"""Pluggable execution backends: plan in, StepResult out.

The port of ``src/repro/backend/__init__.py``.  ``make_backend`` is the
single construction seam used by the engine workers.  Its physical leaves
are ``"torch"`` (the paged surrogate on the paged decode attention kernel,
in the reference's place of ``"jax"``) and ``"cpu"`` (the surrogate with a
plain attention on the CPU); ``"emulated"`` is the calibrated sleep, and
``"hybrid"`` and speculative decode compose them.  The physical backends
are imported lazily, so the emulated path never pulls torch into forked
worker processes.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.backend.base import Backend, StepResult
from repro_torch.backend.emulated import EmulatedBackend

__all__ = ["ARCH_WIDTHS", "Backend", "BACKEND_NAMES", "CpuDecodeBackend",
           "EmulatedBackend", "HybridBackend", "PHYSICAL", "StepResult",
           "TorchBackend", "make_backend"]

BACKEND_NAMES = ("emulated", "torch", "cpu", "hybrid")
PHYSICAL = ("torch", "cpu")           # leaves that own pages and compute

# Surrogate widths at a model's published sizes: query heads, kv heads,
# head_dim = d_model / n_heads, vocab.  qwen2-0.5b: 14 heads, 2 kv heads,
# d_model 896, vocab 151936 (src/repro/configs/qwen2_0_5b.py).
ARCH_WIDTHS = {
    "qwen2-0.5b": dict(n_heads=14, n_kv_heads=2, head_dim=64, vocab=151_936),
}


def __getattr__(name):
    if name == "TorchBackend":
        from repro_torch.backend.torch_backend import TorchBackend
        return TorchBackend
    if name == "CpuDecodeBackend":
        from repro_torch.backend.cpu_decode import CpuDecodeBackend
        return CpuDecodeBackend
    if name == "HybridBackend":
        from repro_torch.backend.hybrid import HybridBackend
        return HybridBackend
    raise AttributeError(name)


def _physical_leaf(name: str, cfg, kv_dtype: str, torch_device, arch):
    """A ``"torch"`` leaf on ``torch_device`` or a ``"cpu"`` leaf, both at
    ``arch``'s widths, so that pages can be handed across."""
    kw = dict(block_size=cfg.block_size, num_blocks=cfg.num_kv_blocks,
              num_swap_blocks=cfg.num_swap_blocks,
              copy_streams=cfg.copy_streams, kv_dtype=kv_dtype,
              **ARCH_WIDTHS.get(arch, {}))
    if name == "torch":
        from repro_torch.backend.torch_backend import TorchBackend
        return TorchBackend(device=torch_device,
                            max_steps=max(cfg.max_steps_per_dispatch,
                                          cfg.speculative_k), **kw)
    from repro_torch.backend.cpu_decode import CpuDecodeBackend
    return CpuDecodeBackend(**kw)


def make_backend(name: str, *, device=None, scheduler_cfg=None,
                 prefill_backend: str = "emulated",
                 decode_backend: str = "emulated",
                 decode_slowdown: float = 8.0,
                 kv_dtype: str = "float32",
                 draft_backend: str = "",
                 draft_slowdown: float = 8.0,
                 spec_accept_rate=None,
                 torch_device=None, arch: Optional[str] = None):
    """Build a backend by name (one of ``BACKEND_NAMES``).

    ``device`` is the ``DeviceModel`` of the emulated sleep;
    ``scheduler_cfg`` sizes the physical page pools (their block ids must
    match the scheduler's manager) and carries ``copy_streams``, the
    async-copy-engine switch, which must be the scheduler's because only
    its in-flight block holds make deferred page copies safe.
    ``torch_device`` is where every ``"torch"`` leaf keeps its pools and
    runs (``None`` = the card, raising without one); a ``"cpu"`` leaf is
    always on the CPU.  ``arch`` sizes every physical leaf from
    ``ARCH_WIDTHS`` (``None`` = the reference's default 4/2/16/256).

    For ``"hybrid"``, ``prefill_backend``/``decode_backend`` name the two
    children, both physical or both emulated; an emulated decode child
    gets the device's ``cpu_tier(decode_slowdown=...)`` cost model, and
    the handoff is priced at the prefill device's swap bandwidth.
    ``kv_dtype="int8"`` stores the KV pool quantized: on a unified
    backend the whole pool, under ``"hybrid"`` only the decode child's,
    so that the handoff copy is where quantization happens.

    When ``scheduler_cfg.speculative_k > 0`` the result is wrapped in
    ``repro_torch.spec.SpeculativeBackend``: ``draft_backend`` names the
    draft child (default ``"cpu"`` for physical targets, ``"emulated"``
    otherwise, which costs ``cpu_tier(draft_slowdown)`` and models
    acceptance with ``spec_accept_rate``), whose physicality must match
    the target's.  The draft's pool is always fp32."""
    import dataclasses

    from repro_torch.core.devmodel import DeviceModel
    from repro_torch.serving.scheduler import SchedulerConfig
    device = device if device is not None else DeviceModel()
    cfg = scheduler_cfg if scheduler_cfg is not None else SchedulerConfig()
    if device.copy_streams != cfg.copy_streams:
        # one switch, two consumers: the scheduler's epoch bookkeeping and
        # the device cost model must see the same stream count
        device = dataclasses.replace(device, copy_streams=cfg.copy_streams)
    if kv_dtype not in ("float32", "int8"):
        raise ValueError(f"kv_dtype must be float32|int8, got {kv_dtype!r}")
    if arch is not None and arch not in ARCH_WIDTHS:
        raise ValueError(f"unknown arch {arch!r} (want one of "
                         f"{sorted(ARCH_WIDTHS)})")

    def leaf(leaf_name: str, dtype: str):
        return _physical_leaf(leaf_name, cfg, dtype, torch_device, arch)

    if name == "emulated":
        base = EmulatedBackend(device.with_kv_dtype(kv_dtype))
    elif name in PHYSICAL:
        base = leaf(name, kv_dtype)
    elif name == "hybrid":
        from repro_torch.backend.hybrid import HybridBackend
        if "hybrid" in (prefill_backend, decode_backend):
            raise ValueError("hybrid children must be leaf backends")
        if (prefill_backend in PHYSICAL) != (decode_backend in PHYSICAL):
            # an emulated child computes no KV: pairing it with a physical
            # child silently yields tokens decoded from an all-zero pool
            # (emulated prefill) or a placeholder-0 stream after the first
            # token (emulated decode) — reject rather than mislead
            raise ValueError(
                f"hybrid children must be both physical (torch/cpu) or both "
                f"emulated, got prefill={prefill_backend!r} "
                f"decode={decode_backend!r}")

        def child(child_name: str, role: str):
            # int8 lives on the DECODE tier only: prefill stays fp32 and
            # the handoff copy quantizes (docs/spec_decode.md)
            tier_dtype = kv_dtype if role == "decode" else "float32"
            if child_name == "emulated":
                dev = (device.cpu_tier(decode_slowdown=decode_slowdown)
                       .with_kv_dtype(tier_dtype)
                       if role == "decode" else device)
                return EmulatedBackend(dev)
            if child_name not in PHYSICAL:
                raise ValueError(f"unknown hybrid child {child_name!r}")
            return leaf(child_name, tier_dtype)

        base = HybridBackend(
            child(prefill_backend, "prefill"),
            child(decode_backend, "decode"),
            t_handoff_block=device.t_swap_block
            * (0.5 if kv_dtype == "int8" else 1.0),
            copy_streams=cfg.copy_streams,
            t_submit_per_copy=device.t_submit_per_copy)
    else:
        raise ValueError(f"unknown backend {name!r} "
                         f"(want one of {BACKEND_NAMES})")

    if cfg.speculative_k <= 0:
        return base
    from repro_torch.spec import SpeculativeBackend
    target_physical = (name in PHYSICAL
                       or (name == "hybrid" and prefill_backend in PHYSICAL))
    dname = draft_backend or ("cpu" if target_physical else "emulated")
    if dname not in PHYSICAL + ("emulated",):
        raise ValueError(f"draft_backend must be torch|cpu|emulated, "
                         f"got {dname!r}")
    if (dname in PHYSICAL) != target_physical:
        # a draft without pages cannot feed a physical verify (and a
        # physical draft under an emulated target would decode garbage)
        raise ValueError(
            f"draft must match the target's physicality: "
            f"target={'physical' if target_physical else 'emulated'}, "
            f"draft_backend={dname!r}")
    if dname == "emulated":
        draft = EmulatedBackend(
            device.cpu_tier(decode_slowdown=draft_slowdown))
    else:
        draft = leaf(dname, "float32")                  # fp32 draft pool
    return SpeculativeBackend(draft, base, accept_rate=spec_accept_rate)
