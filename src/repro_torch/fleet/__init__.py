"""Fleet serving: N engine replicas behind an affinity/pressure router.

See docs/fleet.md.  The router and autoscaler are pure decision logic;
``frontend`` wires them to real ``ServingSystem`` replicas of the port.

Copied from ``src/repro/fleet/__init__.py``, with its imports rewritten to
``repro_torch``; the reference's simulated fleet (its DES) is not ported.
"""
from repro_torch.fleet.autoscale import (AutoscalerConfig, FleetAutoscaler,
                                         Recommendation, ReplicaSignals)
from repro_torch.fleet.frontend import (FleetServingFrontend,
                                        leading_word_keys)
from repro_torch.fleet.router import (POLICIES, FleetRouter, PrefixSummary,
                                      RouterConfig, leading_block_keys)

__all__ = [
    "AutoscalerConfig", "FleetAutoscaler", "Recommendation",
    "ReplicaSignals", "FleetServingFrontend", "leading_word_keys",
    "POLICIES", "FleetRouter", "PrefixSummary", "RouterConfig",
    "leading_block_keys",
]
