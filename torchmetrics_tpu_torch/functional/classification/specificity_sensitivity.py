"""Best specificity at a fixed sensitivity floor (counterpart of
``torchmetrics_tpu/functional/classification/specificity_sensitivity.py``): a selection on the ROC
curve of the shared curve state. The best row is the first maximum, as ``jnp.argmax`` and
``torch.argmax`` both take it."""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _as_tensor,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_tensor_validation,
)
from torchmetrics_tpu_torch.functional.classification.recall_fixed_precision import (
    NO_THRESHOLD,
    _binary_curve_state,
    _multiclass_curve_state,
    _multilabel_curve_state,
    _per_row,
    _validate_floor,
)
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)


def _specificity_at_sensitivity(
    specificity: Tensor, sensitivity: Tensor, thresholds: Tensor, min_sensitivity: float
) -> Tuple[Tensor, Tensor]:
    """max specificity subject to sensitivity >= min_sensitivity; (0, 1e6) when infeasible."""
    mask = sensitivity >= min_sensitivity
    spec_m = torch.where(mask, specificity, -1.0)
    idx = torch.argmax(spec_m, dim=-1, keepdim=True)
    has_any = mask.any(dim=-1)
    best = torch.where(has_any, torch.gather(spec_m, -1, idx)[..., 0], 0.0).clamp_min(0.0)
    thr = torch.gather(thresholds.expand(spec_m.shape), -1, idx)[..., 0]
    return best, torch.where(has_any, thr, NO_THRESHOLD)


def _val_arg(min_sensitivity: float) -> None:
    _validate_floor(min_sensitivity, "min_sensitivity")


def _one_minus(fpr: Union[Tensor, List[Tensor]]) -> Union[Tensor, List[Tensor]]:
    return [1 - f for f in fpr] if isinstance(fpr, list) else 1 - fpr


def _binary_specificity_at_sensitivity_compute(state, thresholds: Optional[Tensor], min_sensitivity: float):
    fpr, tpr, thr = _binary_roc_compute(state, thresholds)
    return _specificity_at_sensitivity(1 - fpr, tpr, thr, min_sensitivity)


def _multiclass_specificity_at_sensitivity_compute(state, num_classes: int, thresholds: Optional[Tensor],
                                                   min_sensitivity: float):
    fpr, tpr, thr = _multiclass_roc_compute(state, num_classes, thresholds)
    return _per_row(_specificity_at_sensitivity, _one_minus(fpr), tpr, thr, min_sensitivity)


def _multilabel_specificity_at_sensitivity_compute(state, num_labels: int, thresholds: Optional[Tensor],
                                                   ignore_index: Optional[int], min_sensitivity: float):
    fpr, tpr, thr = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    return _per_row(_specificity_at_sensitivity, _one_minus(fpr), tpr, thr, min_sensitivity)


def binary_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """(max specificity, threshold) at fixed sensitivity (reference ``:130``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _val_arg(min_sensitivity)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    state, thresholds = _binary_curve_state(preds, target, thresholds, ignore_index)
    return _binary_specificity_at_sensitivity_compute(state, thresholds, min_sensitivity)


def multiclass_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-class (max specificity, threshold) at fixed sensitivity (reference ``:232``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _val_arg(min_sensitivity)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    state, thresholds = _multiclass_curve_state(preds, target, num_classes, thresholds, ignore_index)
    return _multiclass_specificity_at_sensitivity_compute(state, num_classes, thresholds, min_sensitivity)


def multilabel_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_sensitivity: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-label (max specificity, threshold) at fixed sensitivity (reference ``:330``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _val_arg(min_sensitivity)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    state, thresholds = _multilabel_curve_state(preds, target, num_labels, thresholds, ignore_index)
    return _multilabel_specificity_at_sensitivity_compute(state, num_labels, thresholds, ignore_index, min_sensitivity)
