"""Best precision at a fixed recall floor (counterpart of
``torchmetrics_tpu/functional/classification/precision_fixed_recall.py``): the selection of
:mod:`.recall_fixed_precision` with the roles of precision and recall swapped."""
from __future__ import annotations

from typing import Optional, Tuple

from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _as_tensor,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_tensor_validation,
)
from torchmetrics_tpu_torch.functional.classification.recall_fixed_precision import (
    _binary_curve_state,
    _binary_recall_at_fixed_precision_arg_validation,
    _lex_select_at_constraint,
    _multiclass_curve_state,
    _multiclass_recall_at_fixed_precision_arg_validation,
    _multilabel_curve_state,
    _multilabel_recall_at_fixed_precision_arg_validation,
    _per_row,
)


def _precision_at_recall(
    precision: Tensor, recall: Tensor, thresholds: Tensor, min_recall: float
) -> Tuple[Tensor, Tensor]:
    return _lex_select_at_constraint(precision, recall, thresholds, recall, min_recall)


def _binary_precision_at_fixed_recall_compute(state, thresholds: Optional[Tensor], min_recall: float):
    precision, recall, thresholds = _binary_precision_recall_curve_compute(state, thresholds)
    return _precision_at_recall(precision, recall, thresholds, min_recall)


def _multiclass_precision_at_fixed_recall_compute(state, num_classes: int, thresholds: Optional[Tensor],
                                                  min_recall: float):
    precision, recall, thresholds = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    return _per_row(_precision_at_recall, precision, recall, thresholds, min_recall)


def _multilabel_precision_at_fixed_recall_compute(state, num_labels: int, thresholds: Optional[Tensor],
                                                  ignore_index: Optional[int], min_recall: float):
    precision, recall, thresholds = _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)
    return _per_row(_precision_at_recall, precision, recall, thresholds, min_recall)


def binary_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """(max precision, threshold) subject to recall >= min_recall (reference ``:140``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_recall_at_fixed_precision_arg_validation(min_recall, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    state, thresholds = _binary_curve_state(preds, target, thresholds, ignore_index)
    return _binary_precision_at_fixed_recall_compute(state, thresholds, min_recall)


def multiclass_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-class (max precision, threshold) at fixed recall (reference ``:248``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_recall_at_fixed_precision_arg_validation(num_classes, min_recall, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    state, thresholds = _multiclass_curve_state(preds, target, num_classes, thresholds, ignore_index)
    return _multiclass_precision_at_fixed_recall_compute(state, num_classes, thresholds, min_recall)


def multilabel_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_recall: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-label (max precision, threshold) at fixed recall (reference ``:348``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_recall_at_fixed_precision_arg_validation(num_labels, min_recall, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    state, thresholds = _multilabel_curve_state(preds, target, num_labels, thresholds, ignore_index)
    return _multilabel_precision_at_fixed_recall_compute(state, num_labels, thresholds, ignore_index, min_recall)
