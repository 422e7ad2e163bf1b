"""Stateful recall at a fixed precision (counterpart of
``torchmetrics_tpu/classification/recall_fixed_precision.py``: ``BinaryRecallAtFixedPrecision:25``,
``MulticlassRecallAtFixedPrecision:54``, ``MultilabelRecallAtFixedPrecision:90`` and the task
wrapper ``RecallAtFixedPrecision:126``).

Subclasses of the curve classes, so all three state regimes come with them: exact (``cat`` list
states), binned (one K3 launch per update) and ``approx="sketch"`` (one K2 ``sketch_update``
launch per update). The fixed-point metrics of one task and thresholds share their state, so a
``MetricCollection`` of them, with AUROC and AP beside, is one compute group.
"""
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
from torchmetrics_tpu_torch.functional.classification.recall_fixed_precision import (
    _binary_recall_at_fixed_precision_arg_validation,
    _binary_recall_at_fixed_precision_compute,
    _multiclass_recall_at_fixed_precision_arg_validation,
    _multiclass_recall_at_fixed_precision_compute,
    _multilabel_recall_at_fixed_precision_arg_validation,
    _multilabel_recall_at_fixed_precision_compute,
)


class BinaryRecallAtFixedPrecision(BinaryPrecisionRecallCurve):
    """Reference ``classification/recall_fixed_precision.py:47``."""

    higher_is_better = True

    def __init__(self, min_precision: float, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_recall_at_fixed_precision_arg_validation(min_precision, thresholds, ignore_index)
        self.min_precision = min_precision
        self.validate_args = validate_args

    def _compute(self, state):
        return _binary_recall_at_fixed_precision_compute(self._curve_state(state), self.thresholds, self.min_precision)


class MulticlassRecallAtFixedPrecision(MulticlassPrecisionRecallCurve):
    """Reference ``classification/recall_fixed_precision.py:177``."""

    higher_is_better = True

    def __init__(self, num_classes: int, min_precision: float, thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _multiclass_recall_at_fixed_precision_arg_validation(num_classes, min_precision, thresholds, ignore_index)
        self.min_precision = min_precision
        self.validate_args = validate_args

    def _compute(self, state):
        return _multiclass_recall_at_fixed_precision_compute(
            self._curve_state(state), self.num_classes, self.thresholds, self.min_precision
        )


class MultilabelRecallAtFixedPrecision(MultilabelPrecisionRecallCurve):
    """Reference ``classification/recall_fixed_precision.py:323``."""

    higher_is_better = True

    def __init__(self, num_labels: int, min_precision: float, thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _multilabel_recall_at_fixed_precision_arg_validation(num_labels, min_precision, thresholds, ignore_index)
        self.min_precision = min_precision
        self.validate_args = validate_args

    def _compute(self, state):
        return _multilabel_recall_at_fixed_precision_compute(
            self._curve_state(state), self.num_labels, self.thresholds, self.ignore_index, self.min_precision
        )


class RecallAtFixedPrecision(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``recall_fixed_precision.py:468``)."""

    def __new__(  # type: ignore[misc]
        cls, task: str, min_precision: float, thresholds: Thresholds = None, num_classes: Optional[int] = None,
        num_labels: Optional[int] = None, ignore_index: Optional[int] = None, validate_args: bool = True,
        **kwargs: Any,
    ):
        classes = (BinaryRecallAtFixedPrecision, MulticlassRecallAtFixedPrecision, MultilabelRecallAtFixedPrecision)
        args = (min_precision, thresholds, ignore_index, validate_args)
        return _task_metric(task, num_classes, num_labels, classes, kwargs, binary_args=args, class_args=args)
