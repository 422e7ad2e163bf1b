"""Average precision (counterpart of ``torchmetrics_tpu/functional/classification/average_precision.py``).

AP = Σ (R_n - R_{n-1}) · P_n over the precision-recall curve (step interpolation, sklearn
semantics), from the shared curve state.
"""
from __future__ import annotations

from typing import List, Optional, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.auroc import (
    _flat_exact,
    _multiclass_support,
    _multilabel_support,
    _reduce_per_class,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    ExactState,
    Thresholds,
    _as_tensor,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _dispatch,
    _is_binned,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


def _ap_from_curve(precision: Tensor, recall: Tensor) -> Tensor:
    """AP along the last axis of a ``(..., T+1)`` curve pair (recall decreasing)."""
    return -torch.sum((recall[..., 1:] - recall[..., :-1]) * precision[..., :-1], dim=-1)


def _reduce_average_precision(
    precision: Union[Tensor, List[Tensor]],
    recall: Union[Tensor, List[Tensor]],
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Per-class APs and their macro, weighted or no reduction (reference ``average_precision.py:30``)."""
    if isinstance(precision, (list, tuple)):
        res = torch.stack([_ap_from_curve(p, r) for p, r in zip(precision, recall)])
    else:
        res = _ap_from_curve(precision, recall)
    return _reduce_per_class(res, average, weights)


def _binary_average_precision_compute(state: Union[Tensor, ExactState], thresholds: Optional[Tensor]) -> Tensor:
    precision, recall, _ = _binary_precision_recall_curve_compute(state, thresholds)
    return _ap_from_curve(precision, recall)


def binary_average_precision(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """AP for binary tasks (reference ``average_precision.py:94``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, weight, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None:
        return _binary_average_precision_compute((preds, target, weight), None)
    state = _binary_precision_recall_curve_update(preds, target, weight, thresholds)
    return _binary_average_precision_compute(state, thresholds)


def _multiclass_average_precision_arg_validation(
    num_classes: int, average: Optional[str] = "macro", thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    allowed_average = ("macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")


def _multiclass_average_precision_compute(
    state: Union[Tensor, ExactState],
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Optional[Tensor] = None,
) -> Tensor:
    precision, recall, _ = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    weights = _multiclass_support(state, num_classes, thresholds)
    return _reduce_average_precision(precision, recall, average, weights=weights)


def multiclass_average_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """One-vs-rest AP for multiclass tasks (reference ``average_precision.py:162``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_average_precision_arg_validation(num_classes, average, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, weight, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    if thresholds is None:
        return _multiclass_average_precision_compute((preds, target, weight), num_classes, average, None)
    state = _multiclass_precision_recall_curve_update(preds, target, weight, num_classes, thresholds)
    return _multiclass_average_precision_compute(state, num_classes, average, thresholds)


def _multilabel_average_precision_arg_validation(
    num_labels: int, average: Optional[str], thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")


def _multilabel_average_precision_compute(
    state: Union[Tensor, ExactState],
    num_labels: int,
    average: Optional[str],
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Tensor:
    if average == "micro":
        if _is_binned(state, thresholds):
            return _binary_average_precision_compute(torch.sum(state, dim=1), thresholds)
        return _binary_average_precision_compute(_flat_exact(state), None)
    precision, recall, _ = _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)
    return _reduce_average_precision(precision, recall, average, weights=_multilabel_support(state, thresholds))


def multilabel_average_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Per-label AP (reference ``average_precision.py:320``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_average_precision_arg_validation(num_labels, average, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, weight, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    if thresholds is None:
        return _multilabel_average_precision_compute((preds, target, weight), num_labels, average, None, ignore_index)
    state = _multilabel_precision_recall_curve_update(preds, target, weight, num_labels, thresholds)
    return _multilabel_average_precision_compute(state, num_labels, average, thresholds, ignore_index)


def average_precision(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching entry (reference ``average_precision.py:476``)."""
    task = _dispatch(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_average_precision(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_average_precision(preds, target, num_classes, average, thresholds, ignore_index, validate_args)
    return multilabel_average_precision(preds, target, num_labels, average, thresholds, ignore_index, validate_args)
