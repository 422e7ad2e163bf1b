"""Stateful AUROC (counterpart of ``torchmetrics_tpu/classification/auroc.py``, reference
``classification/auroc.py:43,168,322,471``)."""
from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    _task_metric,
)
from torchmetrics_tpu_torch.functional.classification.auroc import (
    _binary_auroc_arg_validation,
    _binary_auroc_compute,
    _multiclass_auroc_arg_validation,
    _multiclass_auroc_compute,
    _multilabel_auroc_arg_validation,
    _multilabel_auroc_compute,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import Thresholds


class BinaryAUROC(BinaryPrecisionRecallCurve):
    """Reference ``classification/auroc.py:43``.

    With ``approx="sketch"`` the state is a fixed ``2·sketch_bins``-float histogram pair instead
    of exact mode's growing lists, and |ΔAUROC| against exact mode is bounded by the grid's
    discretisation (``sketch.auroc_error_bound``).
    """
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    higher_is_better = True

    def __init__(
        self,
        max_fpr: Optional[float] = None,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        self.max_fpr = max_fpr
        self.validate_args = validate_args

    def _compute(self, state):
        return _binary_auroc_compute(self._curve_state(state), self.thresholds, self.max_fpr)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) value between the bounds 0 and 1 (JAX ``classification/auroc.py:66``)."""
        from torchmetrics_tpu_torch.utils.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        return plot_single_or_multi_val(val, ax=ax, higher_is_better=self.higher_is_better,
                                        name=type(self).__name__, lower_bound=0.0, upper_bound=1.0)


class MulticlassAUROC(MulticlassPrecisionRecallCurve):
    """Reference ``classification/auroc.py:168``. The curve state stays per class (the base's
    ``average`` is None); ``average`` applies at compute."""
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
            _multiclass_auroc_arg_validation(num_classes, average, thresholds, ignore_index)
        self._auroc_average = average
        self.validate_args = validate_args

    def _compute(self, state):
        return _multiclass_auroc_compute(self._curve_state(state), self.num_classes, self._auroc_average, self.thresholds)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) value between the bounds 0 and 1 (JAX ``classification/auroc.py:120``)."""
        from torchmetrics_tpu_torch.utils.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        return plot_single_or_multi_val(val, ax=ax, higher_is_better=True,
                                        name=type(self).__name__, lower_bound=0.0, upper_bound=1.0)


class MultilabelAUROC(MultilabelPrecisionRecallCurve):
    """Reference ``classification/auroc.py:322``."""
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
            _multilabel_auroc_arg_validation(num_labels, average, thresholds, ignore_index)
        self.average = average
        self.validate_args = validate_args

    def _compute(self, state):
        return _multilabel_auroc_compute(
            self._curve_state(state), self.num_labels, self.average, self.thresholds, self.ignore_index
        )

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) value between the bounds 0 and 1 (JAX ``classification/auroc.py:161``)."""
        from torchmetrics_tpu_torch.utils.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        return plot_single_or_multi_val(val, ax=ax, higher_is_better=True,
                                        name=type(self).__name__, lower_bound=0.0, upper_bound=1.0)


class AUROC(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``auroc.py:471``)."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        classes = (BinaryAUROC, MulticlassAUROC, MultilabelAUROC)
        return _task_metric(task, num_classes, num_labels, classes, kwargs, binary_args=(max_fpr,), class_args=(average,))
