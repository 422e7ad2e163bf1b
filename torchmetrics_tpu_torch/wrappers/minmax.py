"""MinMaxMetric (counterpart of ``torchmetrics_tpu/wrappers/minmax.py``; reference
``src/torchmetrics/wrappers/minmax.py:29``)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


class MinMaxMetric(WrapperMetric):
    """Track the min and max of the wrapped metric's compute over time (reference ``minmax.py:29``).

    ``min_val`` and ``max_val`` are plain float32 tensors on the metric's device, not states, as in
    the JAX package (``minmax.py:34-35``): ``compute`` folds each new value into them.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> from torchmetrics_tpu_torch.wrappers import MinMaxMetric
        >>> metric = MinMaxMetric(BinaryAccuracy(device="cpu"))
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> {k: float(v) for k, v in sorted(metric.compute().items())}
        {'max': 0.75, 'min': 0.75, 'raw': 0.75}
    """

    full_state_update = True

    def __init__(self, base_metric: Metric, **kwargs: Any) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of `torchmetrics_tpu_torch.Metric` but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self._base_metric = base_metric
        self._reset_extremes()

    def _reset_extremes(self) -> None:
        self.min_val = torch.tensor(float("inf"), device=self.device)
        self.max_val = torch.tensor(float("-inf"), device=self.device)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._base_metric.update(*args, **kwargs)
        self._update_count += 1
        self._update_called = True

    def compute(self) -> Dict[str, Any]:
        val = self._base_metric.compute()
        if not self._is_suitable_val(val):
            raise RuntimeError(f"Returned value from base metric must be a float or scalar tensor, but got {val}.")
        val = torch.as_tensor(val, device=self.device)
        self.max_val = torch.maximum(self.max_val, val)
        self.min_val = torch.minimum(self.min_val, val)
        return {"raw": val, "max": self.max_val, "min": self.min_val}

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self.update(*args, **kwargs)
        return self.compute()

    def reset(self) -> None:
        self._base_metric.reset()
        super().reset()
        self._reset_extremes()

    @staticmethod
    def _is_suitable_val(val: Any) -> bool:
        if isinstance(val, (int, float)):
            return True
        if isinstance(val, torch.Tensor):
            return val.numel() == 1
        return False
