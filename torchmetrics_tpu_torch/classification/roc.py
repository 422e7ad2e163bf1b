"""Stateful ROC curves (counterpart of ``torchmetrics_tpu/classification/roc.py``, reference
``classification/roc.py:42,173,339,496``): the precision-recall-curve state with another compute."""
from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    _task_metric,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)


class BinaryROC(BinaryPrecisionRecallCurve):
    """Reference ``classification/roc.py:42``; in sketch mode the ROC points are the exact curve
    points at the implicit ``sketch_bins`` grid."""

    def _compute(self, state):
        return _binary_roc_compute(self._curve_state(state), self.thresholds)

    def plot(self, curve: Any = None, score: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) curve (JAX ``classification/roc.py:35``)."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve or self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=('False positive rate', 'True positive rate'))


class MulticlassROC(MulticlassPrecisionRecallCurve):
    """Reference ``classification/roc.py:173``."""

    def _compute(self, state):
        return _multiclass_roc_compute(self._curve_state(state), self.num_classes, self.thresholds, self.average)

    def plot(self, curve: Any = None, score: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) curve (JAX ``classification/roc.py:50``)."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve or self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=('False positive rate', 'True positive rate'))


class MultilabelROC(MultilabelPrecisionRecallCurve):
    """Reference ``classification/roc.py:339``."""

    def _compute(self, state):
        return _multilabel_roc_compute(self._curve_state(state), self.num_labels, self.thresholds, self.ignore_index)

    def plot(self, curve: Any = None, score: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) curve (JAX ``classification/roc.py:65``)."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve or self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=('False positive rate', 'True positive rate'))


class ROC(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``roc.py:496``)."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        return _task_metric(task, num_classes, num_labels, (BinaryROC, MulticlassROC, MultilabelROC), kwargs)
