"""Hinge loss (counterpart of ``torchmetrics_tpu/classification/hinge.py``: ``BinaryHingeLoss:22``,
``MulticlassHingeLoss:58`` and the task wrapper ``HingeLoss:102``).

float32 ``measures`` (a scalar, or ``(C,)`` for ``one-vs-all``, ``:85``) and ``total`` sum states.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.hinge import (
    _binary_hinge_loss_arg_validation,
    _binary_hinge_loss_tensor_validation,
    _binary_hinge_update,
    _hinge_loss_compute,
    _multiclass_hinge_loss_arg_validation,
    _multiclass_hinge_loss_tensor_validation,
    _multiclass_hinge_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


class _HingeLoss(Metric):
    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def _create_state(self, size: tuple) -> None:
        self.add_state("measures", torch.zeros(size, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _merge(self, state, measures, total):
        return {"measures": state["measures"] + measures, "total": state["total"] + total}

    def _compute(self, state):
        return _hinge_loss_compute(state["measures"], state["total"])


class BinaryHingeLoss(_HingeLoss):
    """Binary hinge loss (reference ``classification/hinge.py:41``)."""
    plot_lower_bound = 0.0

    def __init__(self, squared: bool = False, ignore_index: Optional[int] = None, validate_args: bool = True,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_hinge_loss_arg_validation(squared, ignore_index)
        self.squared = squared
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(())

    def _validate(self, preds, target) -> None:
        if self.validate_args:
            _binary_hinge_loss_tensor_validation(preds, target, self.ignore_index)

    def _update(self, state, preds, target):
        return self._merge(state, *_binary_hinge_update(preds, target, self.squared, self.ignore_index))


class MulticlassHingeLoss(_HingeLoss):
    """Multiclass hinge loss (reference ``classification/hinge.py:170``)."""
    plot_lower_bound = 0.0
    plot_legend_name = 'Class'

    def __init__(self, num_classes: int, squared: bool = False, multiclass_mode: str = "crammer-singer",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_hinge_loss_arg_validation(num_classes, squared, multiclass_mode, ignore_index)
        self.num_classes = num_classes
        self.squared = squared
        self.multiclass_mode = multiclass_mode
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(() if multiclass_mode == "crammer-singer" else (num_classes,))

    def _validate(self, preds, target) -> None:
        if self.validate_args:
            _multiclass_hinge_loss_tensor_validation(preds, target, self.num_classes, self.ignore_index)

    def _update(self, state, preds, target):
        return self._merge(state, *_multiclass_hinge_update(preds, target, self.num_classes, self.squared,
                                                            self.multiclass_mode, self.ignore_index))


class HingeLoss(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``hinge.py:323``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import HingeLoss
        >>> metric = HingeLoss(task="binary", device="cpu")
        >>> metric.update(torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75]), torch.tensor([0, 0, 1, 1, 1]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.6900
    """

    def __new__(  # type: ignore[misc]
        cls, task: str, num_classes: Optional[int] = None, squared: bool = False,
        multiclass_mode: str = "crammer-singer", ignore_index: Optional[int] = None, validate_args: bool = True,
        **kwargs: Any,
    ):
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryHingeLoss(squared, **kwargs)
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` must be `int` but `{type(num_classes)} was passed.`")
        return MulticlassHingeLoss(num_classes, squared, multiclass_mode, **kwargs)
