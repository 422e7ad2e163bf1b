"""Hamming distance (counterpart of ``torchmetrics_tpu/classification/hamming.py``: ``BinaryHammingDistance:16``,
``MulticlassHammingDistance:28``, ``MultilabelHammingDistance:42`` and the task wrapper ``HammingDistance:56``).

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
from torchmetrics_tpu_torch.functional.classification.hamming import _hamming_distance_reduce


class BinaryHammingDistance(BinaryStatScores):
    """Binary Hamming distance (reference ``hamming.py:35``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryHammingDistance
        >>> metric = BinaryHammingDistance(device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.2500
    """
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    higher_is_better = False

    def _compute(self, state):
        return _hamming_distance_reduce(state["tp"], state["fp"], state["tn"], state["fn"],
                                        average="binary", multidim_average=self.multidim_average)


class MulticlassHammingDistance(MulticlassStatScores):
    """Multiclass Hamming distance (reference ``hamming.py:160``)."""
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Class'

    higher_is_better = False

    def _compute(self, state):
        return _hamming_distance_reduce(state["tp"], state["fp"], state["tn"], state["fn"], average=self.average,
                                        multidim_average=self.multidim_average, top_k=self.top_k)


class MultilabelHammingDistance(MultilabelStatScores):
    """Multilabel Hamming distance (reference ``hamming.py:314``)."""
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Label'

    higher_is_better = False

    def _compute(self, state):
        return _hamming_distance_reduce(state["tp"], state["fp"], state["tn"], state["fn"], average=self.average,
                                        multidim_average=self.multidim_average, multilabel=True)


class HammingDistance(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``hamming.py:468``)."""

    def __new__(  # type: ignore[misc]
        cls, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
        num_labels: Optional[int] = None, average: Optional[str] = "micro", multidim_average: str = "global",
        top_k: Optional[int] = 1, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ):
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        classes = (BinaryHammingDistance, MulticlassHammingDistance, MultilabelHammingDistance)
        return _stat_scores_task_metric(task, classes, threshold, num_classes, num_labels, average, top_k, kwargs)
