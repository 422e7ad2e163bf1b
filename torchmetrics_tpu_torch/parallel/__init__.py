"""Distributed state sync of the port (counterpart of ``torchmetrics_tpu/parallel``).

The ported subset of the JAX package's ``parallel.__all__`` (``parallel/__init__.py:56``): the
replicated sync of ``sync.py`` on ``torch.distributed``, and its bounded, quorum and degraded paths with
the rank health ledger and the skew report. Not ported yet: ``compress`` (ROADMAP queue A item 9b),
``shardable_state``, ``simulate_mesh_world`` and ``mesh.py`` (item 9c).
"""
from torchmetrics_tpu_torch.parallel.sync import (
    FULL,
    LOCAL,
    QUORUM,
    ConsistencyLevel,
    HealthLedger,
    RankHealth,
    SyncedState,
    SyncOptions,
    all_gather_object_shapes,
    as_consistency,
    distributed_available,
    gather_all_arrays,
    health_ledger,
    process_sync,
    quorum_threshold,
    reset_health_state,
    skew_report,
    sync_options_from_env,
    sync_state,
)

__all__ = [
    "FULL",
    "LOCAL",
    "QUORUM",
    "ConsistencyLevel",
    "HealthLedger",
    "RankHealth",
    "SyncOptions",
    "SyncedState",
    "all_gather_object_shapes",
    "as_consistency",
    "distributed_available",
    "gather_all_arrays",
    "health_ledger",
    "process_sync",
    "quorum_threshold",
    "reset_health_state",
    "skew_report",
    "sync_options_from_env",
    "sync_state",
]
