"""Jaccard index (counterpart of ``torchmetrics_tpu/classification/jaccard.py``: ``BinaryJaccardIndex:16``,
``MulticlassJaccardIndex:50``, ``MultilabelJaccardIndex:75`` and the task wrapper ``JaccardIndex:100``).

The classes subclass the confusion-matrix classes with ``normalize=None``: one int64 ``confmat``
state counted by K1, so they share a compute group with the confusion matrix, Cohen's kappa and
MCC of the same task and arguments.
"""
from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from torchmetrics_tpu_torch.functional.classification.jaccard import _jaccard_index_reduce
from torchmetrics_tpu_torch.functional.classification.stat_scores import _check_task
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


class BinaryJaccardIndex(BinaryConfusionMatrix):
    """Binary Jaccard index (reference ``jaccard.py:39``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryJaccardIndex
        >>> metric = BinaryJaccardIndex(device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.5000
    """
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    higher_is_better = True

    def __init__(self, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(threshold=threshold, ignore_index=ignore_index, normalize=None,
                         validate_args=validate_args, **kwargs)

    def _compute(self, state):
        return _jaccard_index_reduce(state["confmat"], average="binary")

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) value as a scalar metric (JAX ``classification/jaccard.py:44``), not as
        the confusion matrix it inherits from."""
        return Metric.plot(self, val, ax)


class MulticlassJaccardIndex(MulticlassConfusionMatrix):
    """Multiclass Jaccard index (reference ``jaccard.py:152``)."""
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Class'

    higher_is_better = True

    def __init__(self, num_classes: int, average: Optional[str] = "macro", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, ignore_index=ignore_index, normalize=None,
                         validate_args=validate_args, **kwargs)
        self.average = average

    def _compute(self, state):
        return _jaccard_index_reduce(state["confmat"], average=self.average, ignore_index=self.ignore_index)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) value as a scalar metric (JAX ``classification/jaccard.py:69``), not as
        the confusion matrix it inherits from."""
        return Metric.plot(self, val, ax)


class MultilabelJaccardIndex(MultilabelConfusionMatrix):
    """Multilabel Jaccard index (reference ``jaccard.py:282``)."""
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Label'

    higher_is_better = True

    def __init__(self, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels=num_labels, threshold=threshold, ignore_index=ignore_index,
                         normalize=None, validate_args=validate_args, **kwargs)
        self.average = average

    def _compute(self, state):
        return _jaccard_index_reduce(state["confmat"], average=self.average)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) value as a scalar metric (JAX ``classification/jaccard.py:94``), not as
        the confusion matrix it inherits from."""
        return Metric.plot(self, val, ax)


class JaccardIndex(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``jaccard.py:417``)."""

    def __new__(  # type: ignore[misc]
        cls, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
        num_labels: Optional[int] = None, average: Optional[str] = "macro",
        ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ):
        task = _check_task(task, num_classes, num_labels)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryJaccardIndex(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassJaccardIndex(num_classes, average, **kwargs)
        return MultilabelJaccardIndex(num_labels, threshold, average, **kwargs)
