"""Cohen's kappa (counterpart of ``torchmetrics_tpu/classification/cohen_kappa.py``: ``BinaryCohenKappa:12``,
``MulticlassCohenKappa:38`` and the task wrapper ``CohenKappa:76``).

The classes subclass the confusion-matrix classes with ``normalize=None`` (one int64 ``confmat``
state counted by K1), so they share a compute group with the Jaccard index and MCC.
"""
from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.confusion_matrix import BinaryConfusionMatrix, MulticlassConfusionMatrix
from torchmetrics_tpu_torch.functional.classification.cohen_kappa import _cohen_kappa_reduce, _validate_weights
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


class BinaryCohenKappa(BinaryConfusionMatrix):
    """Binary Cohen's kappa (reference ``cohen_kappa.py:35``)."""
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    higher_is_better = True

    def __init__(self, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 weights: Optional[str] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(threshold, ignore_index, normalize=None, validate_args=False, **kwargs)
        if validate_args:
            _validate_weights(weights)
        self.weights = weights
        self.validate_args = validate_args

    def _compute(self, state):
        return _cohen_kappa_reduce(state["confmat"], self.weights)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) value as a scalar metric (JAX ``classification/cohen_kappa.py:32``), not as
        the confusion matrix it inherits from."""
        return Metric.plot(self, val, ax)


class MulticlassCohenKappa(MulticlassConfusionMatrix):
    """Multiclass Cohen's kappa (reference ``cohen_kappa.py:159``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassCohenKappa
        >>> metric = MulticlassCohenKappa(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([[0.16, 0.26, 0.58], [0.22, 0.61, 0.17],
        ...                             [0.71, 0.09, 0.20], [0.05, 0.82, 0.13]]), torch.tensor([2, 1, 0, 0]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.6364
    """
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    higher_is_better = True

    def __init__(self, num_classes: int, ignore_index: Optional[int] = None,
                 weights: Optional[str] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes, ignore_index, normalize=None, validate_args=False, **kwargs)
        if validate_args:
            _validate_weights(weights)
        self.weights = weights
        self.validate_args = validate_args

    def _compute(self, state):
        return _cohen_kappa_reduce(state["confmat"], self.weights)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) value as a scalar metric (JAX ``classification/cohen_kappa.py:70``), not as
        the confusion matrix it inherits from."""
        return Metric.plot(self, val, ax)


class CohenKappa(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``cohen_kappa.py:287``)."""

    def __new__(  # type: ignore[misc]
        cls, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
        weights: Optional[str] = None, ignore_index: Optional[int] = None,
        validate_args: bool = True, **kwargs: Any,
    ):
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"weights": weights, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryCohenKappa(threshold, **kwargs)
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` must be `int` but `{type(num_classes)} was passed.`")
        return MulticlassCohenKappa(num_classes, **kwargs)
