"""Stateful average precision (counterpart of ``torchmetrics_tpu/classification/average_precision.py``,
reference ``classification/average_precision.py:46,162,320,476``)."""
from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    _task_metric,
)
from torchmetrics_tpu_torch.functional.classification.average_precision import (
    _binary_average_precision_compute,
    _multiclass_average_precision_arg_validation,
    _multiclass_average_precision_compute,
    _multilabel_average_precision_arg_validation,
    _multilabel_average_precision_compute,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds


class BinaryAveragePrecision(BinaryPrecisionRecallCurve):
    """Reference ``classification/average_precision.py:46``."""
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    higher_is_better = True

    def _compute(self, state):
        return _binary_average_precision_compute(self._curve_state(state), self.thresholds)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) value between the bounds 0 and 1 (JAX ``classification/average_precision.py:36``)."""
        from torchmetrics_tpu_torch.utils.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        return plot_single_or_multi_val(val, ax=ax, higher_is_better=True,
                                        name=type(self).__name__, lower_bound=0.0, upper_bound=1.0)


class MulticlassAveragePrecision(MulticlassPrecisionRecallCurve):
    """Reference ``classification/average_precision.py:162``. The curve state stays per class;
    ``average`` applies at compute."""
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Class'

    higher_is_better = True

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multiclass_average_precision_arg_validation(num_classes, average, thresholds, ignore_index)
        self._ap_average = average
        self.validate_args = validate_args

    def _compute(self, state):
        return _multiclass_average_precision_compute(
            self._curve_state(state), self.num_classes, self._ap_average, self.thresholds
        )

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) value between the bounds 0 and 1 (JAX ``classification/average_precision.py:77``)."""
        from torchmetrics_tpu_torch.utils.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        return plot_single_or_multi_val(val, ax=ax, higher_is_better=True,
                                        name=type(self).__name__, lower_bound=0.0, upper_bound=1.0)


class MultilabelAveragePrecision(MultilabelPrecisionRecallCurve):
    """Reference ``classification/average_precision.py:320``."""
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    plot_legend_name = 'Label'

    higher_is_better = True

    def __init__(
        self,
        num_labels: int,
        average: Optional[str] = "macro",
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _multilabel_average_precision_arg_validation(num_labels, average, thresholds, ignore_index)
        self.average = average
        self.validate_args = validate_args

    def _compute(self, state):
        return _multilabel_average_precision_compute(
            self._curve_state(state), self.num_labels, self.average, self.thresholds, self.ignore_index
        )

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) value between the bounds 0 and 1 (JAX ``classification/average_precision.py:118``)."""
        from torchmetrics_tpu_torch.utils.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        return plot_single_or_multi_val(val, ax=ax, higher_is_better=True,
                                        name=type(self).__name__, lower_bound=0.0, upper_bound=1.0)


class AveragePrecision(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``average_precision.py:476``)."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        classes = (BinaryAveragePrecision, MulticlassAveragePrecision, MultilabelAveragePrecision)
        return _task_metric(task, num_classes, num_labels, classes, kwargs, class_args=(average,))
