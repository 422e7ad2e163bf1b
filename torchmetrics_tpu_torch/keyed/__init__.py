"""Keyed multi-tenant metrics (counterpart of ``torchmetrics_tpu.keyed``): every state carries a
leading ``(num_keys, ...)`` tenant axis, and ``update(key_ids, ...)`` routes a mixed-tenant batch
through one program, by segment reductions for sum/max/min-shaped states and a vmap of the per-key
fold otherwise."""
from torchmetrics_tpu_torch.keyed.engine import STRATEGIES, KeyedMetric, KeyedMetricCollection

__all__ = ["KeyedMetric", "KeyedMetricCollection", "STRATEGIES"]
