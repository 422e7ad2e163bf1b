"""WrapperMetric base (counterpart of ``torchmetrics_tpu/wrappers/abstract.py``; reference
``src/torchmetrics/wrappers/abstract.py:19-42``).

Wrappers forward everything to the wrapped metric. The port has no state sync yet, so the JAX
package's no-op ``_sync_dist`` has nothing to override.
"""
from __future__ import annotations

from typing import Any

from torchmetrics_tpu_torch.metric import Metric


class WrapperMetric(Metric):
    """Abstract base class for wrapper metrics."""

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        raise NotImplementedError
