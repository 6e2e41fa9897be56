"""Copied from ``src/repro/serving/__init__.py``, with its imports
rewritten to ``repro_torch``."""
from repro_torch.serving.blocks import BlockManager
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig, StepPlan

__all__ = ["BlockManager", "Request", "RequestState", "Scheduler",
           "SchedulerConfig", "StepPlan"]
