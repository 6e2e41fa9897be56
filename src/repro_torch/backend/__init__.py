"""Pluggable execution backends: plan in, StepResult out.

The port of ``src/repro/backend/__init__.py``.  ``make_backend`` is the
single construction seam used by the engine workers.  Its leaves are
``"emulated"`` (the calibrated sleep) and ``"torch"`` (the paged surrogate
on the paged decode attention kernel); the reference's ``"cpu"`` and
``"hybrid"`` backends and speculative decode are not ported yet and raise.
``TorchBackend`` is imported lazily, so the emulated path never pulls
torch into forked worker processes.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.backend.base import Backend, StepResult
from repro_torch.backend.emulated import EmulatedBackend

__all__ = ["ARCH_WIDTHS", "Backend", "BACKEND_NAMES", "EmulatedBackend",
           "StepResult", "TorchBackend", "make_backend"]

BACKEND_NAMES = ("emulated", "torch")
NOT_PORTED = ("cpu", "hybrid")

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
    raise AttributeError(name)


def make_backend(name: str, *, device=None, scheduler_cfg=None,
                 kv_dtype: str = "float32", torch_device=None,
                 arch: Optional[str] = None):
    """Build a backend by name (one of ``BACKEND_NAMES``).

    ``device`` is the ``DeviceModel`` of the emulated sleep;
    ``scheduler_cfg`` sizes the physical page pools (their block ids must
    match the scheduler's manager) and carries ``copy_streams``, the
    async-copy-engine switch, which must be the scheduler's because only
    its in-flight block holds make deferred page copies safe.
    ``torch_device`` is where a ``"torch"`` backend keeps its pools and
    runs (``None`` = the card, raising without one); ``arch`` sizes its
    surrogate from ``ARCH_WIDTHS`` (``None`` = the reference's default
    4/2/16/256).  ``kv_dtype="int8"`` stores the KV pool quantized."""
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
    if name in NOT_PORTED or cfg.speculative_k > 0:
        what = name if name in NOT_PORTED else "speculative decode"
        raise NotImplementedError(f"{what} is not yet ported to repro_torch "
                                  f"(ROADMAP.md, Queue 1)")
    if arch is not None and arch not in ARCH_WIDTHS:
        raise ValueError(f"unknown arch {arch!r} (want one of "
                         f"{sorted(ARCH_WIDTHS)})")
    if name == "emulated":
        return EmulatedBackend(device.with_kv_dtype(kv_dtype))
    if name == "torch":
        from repro_torch.backend.torch_backend import TorchBackend
        return TorchBackend(block_size=cfg.block_size,
                            num_blocks=cfg.num_kv_blocks,
                            num_swap_blocks=cfg.num_swap_blocks,
                            copy_streams=cfg.copy_streams, kv_dtype=kv_dtype,
                            device=torch_device,
                            **ARCH_WIDTHS.get(arch, {}))
    raise ValueError(f"unknown backend {name!r} "
                     f"(want one of {BACKEND_NAMES})")
