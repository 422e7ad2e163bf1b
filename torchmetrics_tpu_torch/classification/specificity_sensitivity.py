"""Stateful specificity at a fixed sensitivity (counterpart of
``torchmetrics_tpu/classification/specificity_sensitivity.py``: ``BinarySpecificityAtSensitivity:28``,
``MulticlassSpecificityAtSensitivity:54``, ``MultilabelSpecificityAtSensitivity:91`` and the task
wrapper ``SpecificityAtSensitivity:130``), in the three state regimes of the curve classes."""
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
from torchmetrics_tpu_torch.functional.classification.specificity_sensitivity import (
    _binary_specificity_at_sensitivity_compute,
    _multiclass_specificity_at_sensitivity_compute,
    _multilabel_specificity_at_sensitivity_compute,
    _val_arg,
)


class BinarySpecificityAtSensitivity(BinaryPrecisionRecallCurve):
    """Reference ``classification/specificity_sensitivity.py:46``."""

    higher_is_better = True

    def __init__(self, min_sensitivity: float, thresholds: Thresholds = None, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _val_arg(min_sensitivity)
        self.min_sensitivity = min_sensitivity
        self.validate_args = validate_args

    def _compute(self, state):
        return _binary_specificity_at_sensitivity_compute(self._curve_state(state), self.thresholds, self.min_sensitivity)


class MulticlassSpecificityAtSensitivity(MulticlassPrecisionRecallCurve):
    """Reference ``classification/specificity_sensitivity.py:130``."""
    plot_legend_name = 'Class'

    higher_is_better = True

    def __init__(self, num_classes: int, min_sensitivity: float, thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _val_arg(min_sensitivity)
        self.min_sensitivity = min_sensitivity
        self.validate_args = validate_args

    def _compute(self, state):
        return _multiclass_specificity_at_sensitivity_compute(
            self._curve_state(state), self.num_classes, self.thresholds, self.min_sensitivity
        )


class MultilabelSpecificityAtSensitivity(MultilabelPrecisionRecallCurve):
    """Reference ``classification/specificity_sensitivity.py:232``."""
    plot_legend_name = 'Label'

    higher_is_better = True

    def __init__(self, num_labels: int, min_sensitivity: float, thresholds: Thresholds = None,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _val_arg(min_sensitivity)
        self.min_sensitivity = min_sensitivity
        self.validate_args = validate_args

    def _compute(self, state):
        return _multilabel_specificity_at_sensitivity_compute(
            self._curve_state(state), self.num_labels, self.thresholds, self.ignore_index, self.min_sensitivity
        )


class SpecificityAtSensitivity(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``specificity_sensitivity.py:330``)."""

    def __new__(  # type: ignore[misc]
        cls, task: str, min_sensitivity: float, thresholds: Thresholds = None, num_classes: Optional[int] = None,
        num_labels: Optional[int] = None, ignore_index: Optional[int] = None, validate_args: bool = True,
        **kwargs: Any,
    ):
        classes = (BinarySpecificityAtSensitivity, MulticlassSpecificityAtSensitivity, MultilabelSpecificityAtSensitivity)
        args = (min_sensitivity, thresholds, ignore_index, validate_args)
        return _task_metric(task, num_classes, num_labels, classes, kwargs, binary_args=args, class_args=args)
