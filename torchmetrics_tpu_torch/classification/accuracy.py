"""Accuracy (counterpart of ``torchmetrics_tpu/classification/accuracy.py``: ``BinaryAccuracy:16``,
``MulticlassAccuracy:43``, ``MultilabelAccuracy:72`` and the task wrapper ``Accuracy:89``)."""
from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _stat_scores_task_metric,
)
from torchmetrics_tpu_torch.functional.classification.accuracy import _accuracy_reduce


class BinaryAccuracy(BinaryStatScores):
    """Binary accuracy (reference ``accuracy.py:31``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> metric = BinaryAccuracy(device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.7500
    """
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    higher_is_better = True

    def _compute(self, state):
        return _accuracy_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"], average="binary", multidim_average=self.multidim_average
        )


class MulticlassAccuracy(MulticlassStatScores):
    """Multiclass accuracy (reference ``accuracy.py:150``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> metric = MulticlassAccuracy(num_classes=3, device="cpu")  # default average='macro'
        >>> metric.update(torch.tensor([[0.16, 0.26, 0.58], [0.22, 0.61, 0.17],
        ...                             [0.71, 0.09, 0.20], [0.05, 0.82, 0.13]]), torch.tensor([2, 1, 0, 0]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.8333
    """
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Class'

    higher_is_better = True

    def _compute(self, state):
        return _accuracy_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"], average=self.average,
            multidim_average=self.multidim_average, top_k=self.top_k,
        )


class MultilabelAccuracy(MultilabelStatScores):
    """Multilabel accuracy (reference ``accuracy.py:302``)."""
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Label'

    higher_is_better = True

    def _compute(self, state):
        return _accuracy_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"], average=self.average,
            multidim_average=self.multidim_average, multilabel=True,
        )


class Accuracy(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``accuracy.py:456-523``)."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        classes = (BinaryAccuracy, MulticlassAccuracy, MultilabelAccuracy)
        return _stat_scores_task_metric(task, classes, threshold, num_classes, num_labels, average, top_k, kwargs)
