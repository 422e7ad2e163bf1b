"""Specificity (counterpart of ``torchmetrics_tpu/classification/specificity.py``: ``BinarySpecificity:16``,
``MulticlassSpecificity:28``, ``MultilabelSpecificity:41`` and the task wrapper ``Specificity:54``).

The classes subclass the stat-score classes, so they share a compute group with ``Accuracy``,
``F1Score`` and the rest of the family: one K1 launch per step for the whole group on the card.
"""
from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _stat_scores_task_metric,
)
from torchmetrics_tpu_torch.functional.classification.specificity import _specificity_reduce


class BinarySpecificity(BinaryStatScores):
    """Binary specificity (reference ``specificity.py:31``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinarySpecificity
        >>> metric = BinarySpecificity(device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    higher_is_better = True

    def _compute(self, state):
        return _specificity_reduce(state["tp"], state["fp"], state["tn"], state["fn"],
                                   average="binary", multidim_average=self.multidim_average)


class MulticlassSpecificity(MulticlassStatScores):
    """Multiclass specificity (reference ``specificity.py:148``)."""

    higher_is_better = True

    def _compute(self, state):
        return _specificity_reduce(state["tp"], state["fp"], state["tn"], state["fn"], average=self.average,
                                   multidim_average=self.multidim_average, top_k=self.top_k)


class MultilabelSpecificity(MultilabelStatScores):
    """Multilabel specificity (reference ``specificity.py:299``)."""

    higher_is_better = True

    def _compute(self, state):
        return _specificity_reduce(state["tp"], state["fp"], state["tn"], state["fn"], average=self.average,
                                   multidim_average=self.multidim_average, multilabel=True)


class Specificity(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``specificity.py:447``)."""

    def __new__(  # type: ignore[misc]
        cls, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
        num_labels: Optional[int] = None, average: Optional[str] = "micro", multidim_average: str = "global",
        top_k: Optional[int] = 1, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ):
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        classes = (BinarySpecificity, MulticlassSpecificity, MultilabelSpecificity)
        return _stat_scores_task_metric(task, classes, threshold, num_classes, num_labels, average, top_k, kwargs)
