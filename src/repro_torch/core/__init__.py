"""The paper's primary contribution: the instrumented CPU control plane.

Copied from ``src/repro/core/__init__.py``, with its imports
rewritten to ``repro_torch``.
"""
from repro_torch.core.devmodel import DeviceModel
from repro_torch.core.engine import EngineConfig, ServingSystem
from repro_torch.core.shm_broadcast import (
    CompletionBoard,
    OpStats,
    ShmBroadcastQueue,
)

__all__ = [
    "CompletionBoard",
    "DeviceModel",
    "EngineConfig",
    "OpStats",
    "ServingSystem",
    "ShmBroadcastQueue",
]
