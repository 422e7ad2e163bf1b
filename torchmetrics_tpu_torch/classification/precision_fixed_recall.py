"""Stateful precision at a fixed recall (counterpart of
``torchmetrics_tpu/classification/precision_fixed_recall.py``: ``BinaryPrecisionAtFixedRecall:32``,
``MulticlassPrecisionAtFixedRecall:60``, ``MultilabelPrecisionAtFixedRecall:99`` and the task
wrapper ``PrecisionAtFixedRecall:138``), in the three state regimes of the curve classes."""
from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    _task_metric,
)
from torchmetrics_tpu_torch.functional.classification.precision_fixed_recall import (
    _binary_precision_at_fixed_recall_compute,
    _multiclass_precision_at_fixed_recall_compute,
    _multilabel_precision_at_fixed_recall_compute,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds
from torchmetrics_tpu_torch.functional.classification.recall_fixed_precision import (
    _binary_recall_at_fixed_precision_arg_validation,
    _multiclass_recall_at_fixed_precision_arg_validation,
    _multilabel_recall_at_fixed_precision_arg_validation,
)


class BinaryPrecisionAtFixedRecall(BinaryPrecisionRecallCurve):
    """Reference ``classification/precision_fixed_recall.py:48``."""

    higher_is_better = True

    def __init__(self, min_recall: float, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_recall_at_fixed_precision_arg_validation(min_recall, thresholds, ignore_index)
        self.min_recall = min_recall
        self.validate_args = validate_args

    def _compute(self, state):
        return _binary_precision_at_fixed_recall_compute(self._curve_state(state), self.thresholds, self.min_recall)


class MulticlassPrecisionAtFixedRecall(MulticlassPrecisionRecallCurve):
    """Reference ``classification/precision_fixed_recall.py:180``."""

    higher_is_better = True

    def __init__(self, num_classes: int, min_recall: float, thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _multiclass_recall_at_fixed_precision_arg_validation(num_classes, min_recall, thresholds, ignore_index)
        self.min_recall = min_recall
        self.validate_args = validate_args

    def _compute(self, state):
        return _multiclass_precision_at_fixed_recall_compute(
            self._curve_state(state), self.num_classes, self.thresholds, self.min_recall
        )


class MultilabelPrecisionAtFixedRecall(MultilabelPrecisionRecallCurve):
    """Reference ``classification/precision_fixed_recall.py:324``."""

    higher_is_better = True

    def __init__(self, num_labels: int, min_recall: float, thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _multilabel_recall_at_fixed_precision_arg_validation(num_labels, min_recall, thresholds, ignore_index)
        self.min_recall = min_recall
        self.validate_args = validate_args

    def _compute(self, state):
        return _multilabel_precision_at_fixed_recall_compute(
            self._curve_state(state), self.num_labels, self.thresholds, self.ignore_index, self.min_recall
        )


class PrecisionAtFixedRecall(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``precision_fixed_recall.py:469``)."""

    def __new__(  # type: ignore[misc]
        cls, task: str, min_recall: float, thresholds: Thresholds = None, num_classes: Optional[int] = None,
        num_labels: Optional[int] = None, ignore_index: Optional[int] = None, validate_args: bool = True,
        **kwargs: Any,
    ):
        classes = (BinaryPrecisionAtFixedRecall, MulticlassPrecisionAtFixedRecall, MultilabelPrecisionAtFixedRecall)
        args = (min_recall, thresholds, ignore_index, validate_args)
        return _task_metric(task, num_classes, num_labels, classes, kwargs, binary_args=args, class_args=args)
