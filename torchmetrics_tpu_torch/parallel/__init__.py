"""Distributed state sync of the port (counterpart of ``torchmetrics_tpu/parallel``).

The ported subset of the JAX package's ``parallel.__all__`` (``parallel/__init__.py:56``): the
replicated sync of ``sync.py`` on ``torch.distributed``. Not ported yet (ROADMAP queue A item 9):
``compress``, ``HealthLedger``/``RankHealth``/``health_ledger``/``reset_health_state``,
``quorum_threshold``, ``skew_report``, ``sync_options_from_env``, ``shardable_state``,
``simulate_mesh_world`` and ``mesh.py``.
"""
from torchmetrics_tpu_torch.parallel.sync import (
    FULL,
    LOCAL,
    QUORUM,
    ConsistencyLevel,
    SyncedState,
    SyncOptions,
    all_gather_object_shapes,
    as_consistency,
    distributed_available,
    gather_all_arrays,
    process_sync,
    sync_state,
)

__all__ = [
    "FULL",
    "LOCAL",
    "QUORUM",
    "ConsistencyLevel",
    "SyncOptions",
    "SyncedState",
    "all_gather_object_shapes",
    "as_consistency",
    "distributed_available",
    "gather_all_arrays",
    "process_sync",
    "sync_state",
]
