"""The discrete-event simulator (DES): the GPS CPU model and the serving
pipeline on it.

Copied from ``src/repro/sim/__init__.py``, with its imports rewritten to
``repro_torch``.
"""
from repro_torch.sim.core import Sim, Proc
from repro_torch.sim.serving import ServingModel, ServingParams, WorkloadResult

__all__ = ["Sim", "Proc", "ServingModel", "ServingParams", "WorkloadResult"]
