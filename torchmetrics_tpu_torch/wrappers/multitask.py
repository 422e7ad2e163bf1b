"""MultitaskWrapper (counterpart of ``torchmetrics_tpu/wrappers/multitask.py``; reference
``src/torchmetrics/wrappers/multitask.py:29``)."""
from __future__ import annotations

from typing import Any, Dict, Union

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


def _device_of(metric: Union[Metric, MetricCollection]) -> Any:
    """A task metric's device: a collection's is that of its first member."""
    if isinstance(metric, MetricCollection):
        return next(iter(metric._modules.values())).device
    return metric.device


class MultitaskWrapper(WrapperMetric):
    """Dict of task -> metric; dict preds/targets in, dict results out (reference ``multitask.py:29``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
        >>> from torchmetrics_tpu_torch.wrappers import MultitaskWrapper
        >>> metric = MultitaskWrapper({'cls': BinaryAccuracy(device="cpu"), 'reg': MeanSquaredError(device="cpu")})
        >>> metric.update(
        ...     {'cls': torch.tensor([0.1, 0.4, 0.35, 0.8]), 'reg': torch.tensor([2.5, 0.0])},
        ...     {'cls': torch.tensor([0, 0, 1, 1]), 'reg': torch.tensor([3.0, -0.5])})
        >>> {k: round(float(v), 4) for k, v in sorted(metric.compute().items())}
        {'cls': 0.75, 'reg': 0.25}
    """

    is_differentiable = False

    def __init__(self, task_metrics: Dict[str, Union[Metric, MetricCollection]], **kwargs: Any) -> None:
        if not isinstance(task_metrics, dict):
            raise TypeError(f"Argument `task_metrics` must be a dict. Found task_metrics = {task_metrics}")
        for metric in task_metrics.values():
            if not isinstance(metric, (Metric, MetricCollection)):
                raise TypeError(
                    "Expected each task's metric to be a Metric or a MetricCollection. "
                    f"Found a metric of type {type(metric)}"
                )
        if task_metrics:
            kwargs.setdefault("device", _device_of(next(iter(task_metrics.values()))))
        super().__init__(**kwargs)
        self.task_metrics = task_metrics

    def items(self):
        return self.task_metrics.items()

    def keys(self):
        return self.task_metrics.keys()

    def values(self):
        return self.task_metrics.values()

    def update(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> None:
        """Update each task's metric (reference ``multitask.py:129``)."""
        if task_preds.keys() != task_targets.keys() or task_preds.keys() != self.task_metrics.keys():
            raise ValueError(
                "Expected arguments `task_preds` and `task_targets` to have the same keys as the wrapped"
                f" `task_metrics`. Found task_preds.keys() = {task_preds.keys()},"
                f" task_targets.keys() = {task_targets.keys()}"
                f" and task_metrics.keys() = {self.task_metrics.keys()}"
            )
        for task_name, metric in self.task_metrics.items():
            metric.update(task_preds[task_name], task_targets[task_name])
        self._update_count += 1
        self._update_called = True

    def compute(self) -> Dict[str, Any]:
        return {task_name: metric.compute() for task_name, metric in self.task_metrics.items()}

    def forward(self, task_preds: Dict[str, Any], task_targets: Dict[str, Any]) -> Dict[str, Any]:
        self._update_count += 1
        self._update_called = True
        return {
            task_name: metric(task_preds[task_name], task_targets[task_name])
            for task_name, metric in self.task_metrics.items()
        }

    def reset(self) -> None:
        for metric in self.task_metrics.values():
            metric.reset()
        super().reset()
