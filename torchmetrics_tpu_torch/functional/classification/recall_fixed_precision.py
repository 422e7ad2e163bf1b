"""Best recall at a fixed precision floor (counterpart of
``torchmetrics_tpu/functional/classification/recall_fixed_precision.py``).

The selection reads the precision-recall curve of the shared curve state (binned through kernel
K3, exact on the host, or the K2 sketch in the module classes). The JAX package picks the row
with ``jnp.lexsort`` over masked keys (``:35-55``); torch has no lexsort, so
:func:`_lex_select_at_constraint` takes the largest ``(primary, secondary, threshold)`` triple in
three masked-max passes on the device, which picks the same row on ties.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    ExactState,
    Thresholds,
    _as_tensor,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _exact_state,
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

CurveState = Tuple[Union[Tensor, ExactState], Optional[Tensor]]
#: the threshold reported when no row meets the floor, or when the best value is 0
NO_THRESHOLD = 1e6


def _lex_select_at_constraint(
    maximize: Tensor, tiebreak: Tensor, thresholds: Tensor, constraint_value: Tensor, constraint_min: float
) -> Tuple[Tensor, Tensor]:
    """The largest ``maximize`` over the rows with ``constraint_value >= constraint_min``, ties
    broken by the larger ``tiebreak`` and then the larger threshold; returns (best value, its
    threshold) along the last axis.

    Rows that fail the floor take the key -1 in all three places, as in the JAX package, and
    both "no row qualifies" and "the best value is 0" report the threshold 1e6.
    """
    n = min(maximize.shape[-1], tiebreak.shape[-1], thresholds.shape[-1])
    maximize, tiebreak, thresholds = maximize[..., :n], tiebreak[..., :n], thresholds[..., :n]
    mask = constraint_value[..., :n] >= constraint_min
    key_primary = torch.where(mask, maximize, -1.0)
    key_secondary = torch.where(mask, tiebreak, -1.0)
    key_tertiary = torch.where(mask, thresholds, -1.0)
    best_primary = key_primary.max(dim=-1, keepdim=True).values
    on_primary = key_primary == best_primary
    best_secondary = torch.where(on_primary, key_secondary, float("-inf")).max(dim=-1, keepdim=True).values
    on_both = on_primary & (key_secondary == best_secondary)
    thr = torch.where(on_both, key_tertiary, float("-inf")).max(dim=-1).values
    best = torch.where(mask.any(dim=-1), best_primary[..., 0], 0.0).clamp_min(0.0)
    return best, torch.where(best == 0.0, NO_THRESHOLD, thr)


def _recall_at_precision(
    precision: Tensor, recall: Tensor, thresholds: Tensor, min_precision: float
) -> Tuple[Tensor, Tensor]:
    return _lex_select_at_constraint(recall, precision, thresholds, precision, min_precision)


def _per_row(
    select: Callable, first: Union[Tensor, List[Tensor]], second: Union[Tensor, List[Tensor]],
    thresholds: Union[Tensor, List[Tensor]], floor: float,
) -> Tuple[Tensor, Tensor]:
    """``select`` on each class's curve: exact mode's per-class lists one by one, binned curves
    ``(C, T + 1)`` at once with their shared ``(T,)`` thresholds broadcast (``:114-126``)."""
    if isinstance(first, list):
        res = [select(a, b, t, floor) for a, b, t in zip(first, second, thresholds)]
        return torch.stack([v for v, _ in res]), torch.stack([t for _, t in res])
    return select(first, second, thresholds.expand(first.shape[0], thresholds.shape[0]), floor)


def _binary_curve_state(preds: Tensor, target: Tensor, thresholds: Thresholds, ignore_index: Optional[int]) -> CurveState:
    """The curve state of one batch, as the classes keep it: exact ``(preds, target, weight)`` or
    the binned ``(T, 2, 2)`` confmat (one K3 launch), with the threshold grid."""
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds)
    if thresholds is None:
        return _exact_state(preds, target, ignore_index), None
    return _binary_precision_recall_curve_update(preds, target, thresholds, ignore_index), thresholds


def _multiclass_curve_state(
    preds: Tensor, target: Tensor, num_classes: int, thresholds: Thresholds, ignore_index: Optional[int]
) -> CurveState:
    preds, target, thresholds = _multiclass_precision_recall_curve_format(preds, target, num_classes, thresholds)
    if thresholds is None:
        return _exact_state(preds, target, ignore_index), None
    return _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, ignore_index), thresholds


def _multilabel_curve_state(
    preds: Tensor, target: Tensor, num_labels: int, thresholds: Thresholds, ignore_index: Optional[int]
) -> CurveState:
    preds, target, thresholds = _multilabel_precision_recall_curve_format(preds, target, num_labels, thresholds)
    if thresholds is None:
        return _exact_state(preds, target, ignore_index), None
    return _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, ignore_index), thresholds


def _validate_floor(value: float, name: str) -> None:
    if not isinstance(value, float) or not (0 <= value <= 1):
        raise ValueError(f"Argument `{name}` must be an float in the [0,1] range, but got {value}")


def _binary_recall_at_fixed_precision_arg_validation(
    min_precision: float, thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    _validate_floor(min_precision, "min_precision")


def _binary_recall_at_fixed_precision_compute(
    state, thresholds: Optional[Tensor], min_precision: float
) -> Tuple[Tensor, Tensor]:
    precision, recall, thresholds = _binary_precision_recall_curve_compute(state, thresholds)
    return _recall_at_precision(precision, recall, thresholds, min_precision)


def binary_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """(max recall, threshold) subject to precision >= min_precision (reference ``:153``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_recall_at_fixed_precision_arg_validation(min_precision, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    state, thresholds = _binary_curve_state(preds, target, thresholds, ignore_index)
    return _binary_recall_at_fixed_precision_compute(state, thresholds, min_precision)


def _multiclass_recall_at_fixed_precision_arg_validation(
    num_classes: int, min_precision: float, thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    _validate_floor(min_precision, "min_precision")


def _multiclass_recall_at_fixed_precision_compute(
    state, num_classes: int, thresholds: Optional[Tensor], min_precision: float
) -> Tuple[Tensor, Tensor]:
    precision, recall, thresholds = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    return _per_row(_recall_at_precision, precision, recall, thresholds, min_precision)


def multiclass_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-class (max recall, threshold) at fixed precision (reference ``:253``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_recall_at_fixed_precision_arg_validation(num_classes, min_precision, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    state, thresholds = _multiclass_curve_state(preds, target, num_classes, thresholds, ignore_index)
    return _multiclass_recall_at_fixed_precision_compute(state, num_classes, thresholds, min_precision)


def _multilabel_recall_at_fixed_precision_arg_validation(
    num_labels: int, min_precision: float, thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    _validate_floor(min_precision, "min_precision")


def _multilabel_recall_at_fixed_precision_compute(
    state, num_labels: int, thresholds: Optional[Tensor], ignore_index: Optional[int], min_precision: float
) -> Tuple[Tensor, Tensor]:
    precision, recall, thresholds = _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)
    return _per_row(_recall_at_precision, precision, recall, thresholds, min_precision)


def multilabel_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_precision: float,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-label (max recall, threshold) at fixed precision (reference ``:353``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_recall_at_fixed_precision_arg_validation(num_labels, min_precision, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    state, thresholds = _multilabel_curve_state(preds, target, num_labels, thresholds, ignore_index)
    return _multilabel_recall_at_fixed_precision_compute(state, num_labels, thresholds, ignore_index, min_precision)
