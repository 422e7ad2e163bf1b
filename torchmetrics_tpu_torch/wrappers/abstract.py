"""WrapperMetric base (counterpart of ``torchmetrics_tpu/wrappers/abstract.py``; reference
``src/torchmetrics/wrappers/abstract.py:19-42``).

Wrappers forward everything to the wrapped metrics, and sync is their business: each wrapped
metric syncs in its own ``compute``, so the wrapper's own ``_sync_dist`` does nothing.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

from torchmetrics_tpu_torch.metric import Metric


class WrapperMetric(Metric):
    """Abstract base class for wrapper metrics."""

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        pass  # each wrapped metric syncs in its own compute

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError
