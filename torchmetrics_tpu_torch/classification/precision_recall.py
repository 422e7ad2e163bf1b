"""Precision and recall (counterpart of ``torchmetrics_tpu/classification/precision_recall.py``:
the Binary, Multiclass and Multilabel classes ``:17-104`` and the task wrappers ``Precision:105``
and ``Recall:143``)."""
from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _stat_scores_task_metric,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall import _precision_recall_reduce


class BinaryPrecision(BinaryStatScores):
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    higher_is_better = True

    def _compute(self, state):
        return _precision_recall_reduce(
            "precision", state["tp"], state["fp"], state["tn"], state["fn"], average="binary",
            multidim_average=self.multidim_average,
        )


class MulticlassPrecision(MulticlassStatScores):
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Class'
    higher_is_better = True

    def _compute(self, state):
        return _precision_recall_reduce(
            "precision", state["tp"], state["fp"], state["tn"], state["fn"], average=self.average,
            multidim_average=self.multidim_average, top_k=self.top_k,
        )


class MultilabelPrecision(MultilabelStatScores):
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Label'
    higher_is_better = True

    def _compute(self, state):
        return _precision_recall_reduce(
            "precision", state["tp"], state["fp"], state["tn"], state["fn"], average=self.average,
            multidim_average=self.multidim_average, multilabel=True,
        )


class BinaryRecall(BinaryStatScores):
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    higher_is_better = True

    def _compute(self, state):
        return _precision_recall_reduce(
            "recall", state["tp"], state["fp"], state["tn"], state["fn"], average="binary",
            multidim_average=self.multidim_average,
        )


class MulticlassRecall(MulticlassStatScores):
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Class'
    higher_is_better = True

    def _compute(self, state):
        return _precision_recall_reduce(
            "recall", state["tp"], state["fp"], state["tn"], state["fn"], average=self.average,
            multidim_average=self.multidim_average, top_k=self.top_k,
        )


class MultilabelRecall(MultilabelStatScores):
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Label'
    higher_is_better = True

    def _compute(self, state):
        return _precision_recall_reduce(
            "recall", state["tp"], state["fp"], state["tn"], state["fn"], average=self.average,
            multidim_average=self.multidim_average, multilabel=True,
        )


class Precision(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``precision_recall.py:898``)."""

    def __new__(  # type: ignore[misc]
        cls, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
        num_labels: Optional[int] = None, average: Optional[str] = "micro", multidim_average: str = "global",
        top_k: Optional[int] = 1, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ):
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        classes = (BinaryPrecision, MulticlassPrecision, MultilabelPrecision)
        return _stat_scores_task_metric(task, classes, threshold, num_classes, num_labels, average, top_k, kwargs)


class Recall(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``precision_recall.py:961``)."""

    def __new__(  # type: ignore[misc]
        cls, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
        num_labels: Optional[int] = None, average: Optional[str] = "micro", multidim_average: str = "global",
        top_k: Optional[int] = 1, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ):
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        classes = (BinaryRecall, MulticlassRecall, MultilabelRecall)
        return _stat_scores_task_metric(task, classes, threshold, num_classes, num_labels, average, top_k, kwargs)
