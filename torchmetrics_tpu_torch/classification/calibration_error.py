"""Stateful calibration error (counterpart of ``torchmetrics_tpu/classification/calibration_error.py``:
``_CalibrationErrorBase:28``, ``BinaryCalibrationError:54``, ``MulticlassCalibrationError:94`` and
the task wrapper ``CalibrationError:129``).

The state is three float32 ``(n_bins + 1,)`` sums with ``dist_reduce_fx="sum"``, as in the JAX
package: binning against the fixed grid commutes with accumulation, and the extra slot holds
``conf == 1.0``."""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.calibration_error import (
    _binary_calibration_error_arg_validation,
    _binary_calibration_error_tensor_validation,
    _binary_confidences_accuracies,
    _binning_bucketize,
    _ce_compute,
    _multiclass_calibration_error_arg_validation,
    _multiclass_calibration_error_tensor_validation,
    _multiclass_confidences_accuracies,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


class _CalibrationErrorBase(Metric):
    is_differentiable = False
    higher_is_better = False

    def _init_state(self, n_bins: int, norm: str, ignore_index: Optional[int], validate_args: bool) -> None:
        self.n_bins = n_bins
        self.norm = norm
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        for name in ("count", "conf_sum", "acc_sum"):
            self.add_state(name, torch.zeros(n_bins + 1, dtype=torch.float32), dist_reduce_fx="sum")

    def _accumulate(self, state, confidences: Tensor, accuracies: Tensor, weight: Tensor):
        count, conf_sum, acc_sum = _binning_bucketize(confidences, accuracies, weight, self.n_bins)
        return {"count": state["count"] + count, "conf_sum": state["conf_sum"] + conf_sum,
                "acc_sum": state["acc_sum"] + acc_sum}

    def _compute(self, state):
        return _ce_compute(state["count"], state["conf_sum"], state["acc_sum"], self.norm)


class BinaryCalibrationError(_CalibrationErrorBase):
    """Reference ``classification/calibration_error.py:41``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import BinaryCalibrationError
        >>> metric = BinaryCalibrationError(n_bins=2, device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.0125
    """

    def __init__(self, n_bins: int = 15, norm: str = "l1", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        self._init_state(n_bins, norm, ignore_index, validate_args)

    def _validate(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_calibration_error_tensor_validation(preds, target, self.ignore_index)

    def _update(self, state, preds, target):
        return self._accumulate(state, *_binary_confidences_accuracies(preds, target, self.ignore_index))


class MulticlassCalibrationError(_CalibrationErrorBase):
    """Reference ``classification/calibration_error.py:188``."""

    def __init__(self, num_classes: int, n_bins: int = 15, norm: str = "l1", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
        self.num_classes = num_classes
        self._init_state(n_bins, norm, ignore_index, validate_args)

    def _validate(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_calibration_error_tensor_validation(preds, target, self.num_classes, self.ignore_index)

    def _update(self, state, preds, target):
        return self._accumulate(
            state, *_multiclass_confidences_accuracies(preds, target, self.num_classes, self.ignore_index)
        )


class CalibrationError(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``calibration_error.py:342``)."""

    def __new__(  # type: ignore[misc]
        cls, task: str, n_bins: int = 15, norm: str = "l1", num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ):
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"n_bins": n_bins, "norm": norm, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryCalibrationError(**kwargs)
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` must be `int` but `{type(num_classes)} was passed.`")
        return MulticlassCalibrationError(num_classes, **kwargs)
