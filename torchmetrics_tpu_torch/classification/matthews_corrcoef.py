"""Matthews correlation coefficient (counterpart of ``torchmetrics_tpu/classification/matthews_corrcoef.py``:
``BinaryMatthewsCorrCoef:16``, ``MulticlassMatthewsCorrCoef:49``, ``MultilabelMatthewsCorrCoef:71`` and
the task wrapper ``MatthewsCorrCoef:94``).

The classes subclass the confusion-matrix classes with ``normalize=None`` (one int64 ``confmat``
state counted by K1), so they share a compute group with the Jaccard index and Cohen's kappa.
"""
from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from torchmetrics_tpu_torch.functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce
from torchmetrics_tpu_torch.functional.classification.stat_scores import _check_task
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


class BinaryMatthewsCorrCoef(BinaryConfusionMatrix):
    """Binary MCC (reference ``matthews_corrcoef.py:39``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryMatthewsCorrCoef
        >>> metric = BinaryMatthewsCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.5774
    """
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    higher_is_better = True

    def __init__(self, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)

    def _compute(self, state):
        return _matthews_corrcoef_reduce(state["confmat"])

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) value as a scalar metric (JAX ``classification/matthews_corrcoef.py:43``), not as
        the confusion matrix it inherits from."""
        return Metric.plot(self, val, ax)


class MulticlassMatthewsCorrCoef(MulticlassConfusionMatrix):
    """Multiclass MCC (reference ``matthews_corrcoef.py:147``)."""
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    higher_is_better = True

    def __init__(self, num_classes: int, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes, ignore_index, normalize=None, validate_args=validate_args, **kwargs)

    def _compute(self, state):
        return _matthews_corrcoef_reduce(state["confmat"])

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) value as a scalar metric (JAX ``classification/matthews_corrcoef.py:65``), not as
        the confusion matrix it inherits from."""
        return Metric.plot(self, val, ax)


class MultilabelMatthewsCorrCoef(MultilabelConfusionMatrix):
    """Multilabel MCC (reference ``matthews_corrcoef.py:259``)."""
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    higher_is_better = True

    def __init__(self, num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels, threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)

    def _compute(self, state):
        return _matthews_corrcoef_reduce(state["confmat"])

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) value as a scalar metric (JAX ``classification/matthews_corrcoef.py:88``), not as
        the confusion matrix it inherits from."""
        return Metric.plot(self, val, ax)


class MatthewsCorrCoef(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``matthews_corrcoef.py:370``)."""

    def __new__(  # type: ignore[misc]
        cls, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
        num_labels: Optional[int] = None, ignore_index: Optional[int] = None,
        validate_args: bool = True, **kwargs: Any,
    ):
        task = _check_task(task, num_classes, num_labels)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryMatthewsCorrCoef(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassMatthewsCorrCoef(num_classes, **kwargs)
        return MultilabelMatthewsCorrCoef(num_labels, threshold, **kwargs)
