"""torchmetrics_tpu_torch.robust: fault tolerance for the metric engine (counterpart of
``torchmetrics_tpu.robust``).

- **numeric poisoning**, :mod:`~torchmetrics_tpu_torch.robust.guardrails`: opt-in
  ``Metric(nan_policy=...)`` counting (and masking) non-finite inputs inside each update's step, with
  one host read at ``compute()``;
- **preemption and crashes**, :mod:`~torchmetrics_tpu_torch.robust.checkpoint`: versioned,
  CRC-checksummed host-side snapshots (``Metric.snapshot()`` / ``Metric.restore()``, collections
  included), consistent against the graph tier and buffered accumulation, in the JAX package's format;
- **lost epoch tails**, :mod:`~torchmetrics_tpu_torch.robust.journal`: a bounded, CRC-checksummed
  write-ahead journal of update batches between durable snapshots (``Metric.journal(dir, every_k)``),
  so a preempted process restores ``snapshot + replay(journal)``.

:mod:`~torchmetrics_tpu_torch.robust.chaos` holds the fault-injection harness less ``ChaosMatrix`` (the injectors,
``ChaosRunner``, ``SimWorld`` and the scenarios that need neither the wire codecs nor the shard); it is not exported
here until the rest comes (ROADMAP.md, queue A, items 9b and 9c).
"""
from torchmetrics_tpu_torch.robust import checkpoint, guardrails
from torchmetrics_tpu_torch.robust.checkpoint import (
    accept_reconciliation,
    load_snapshot,
    reconciliation_offer,
    restore_collection,
    restore_metric,
    save_snapshot,
    snapshot_collection,
    snapshot_metric,
)
from torchmetrics_tpu_torch.robust.guardrails import POISON_STATE, POLICIES

__all__ = [
    "POISON_STATE",
    "POLICIES",
    "accept_reconciliation",
    "checkpoint",
    "guardrails",
    "journal",
    "load_snapshot",
    "reconciliation_offer",
    "restore_collection",
    "restore_metric",
    "save_snapshot",
    "snapshot_collection",
    "snapshot_metric",
]


def __getattr__(name: str):
    # the journal pulls in the dispatch layer's neighbours; load it lazily so that importing the engine
    # (metric.py -> robust.guardrails) never depends on their import order
    if name == "journal":
        import importlib

        return importlib.import_module(f"torchmetrics_tpu_torch.robust.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
