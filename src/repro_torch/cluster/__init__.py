"""Cluster allocation-log tooling (paper §II-B).

Copied from ``src/repro/cluster/__init__.py``, with its imports rewritten to
``repro_torch``.
"""
from repro_torch.cluster.logs import (
    AllocRecord,
    gpu_hour_weighted_cdf,
    parse_salloc_log,
    synthesize_cluster_log,
)

__all__ = ["AllocRecord", "gpu_hour_weighted_cdf", "parse_salloc_log",
           "synthesize_cluster_log"]
