"""AUROC (counterpart of ``torchmetrics_tpu/functional/classification/auroc.py``).

Trapezoidal area under the ROC curve from the shared curve state; per-class curves reduce with
macro or weighted averaging (``_reduce_auroc``). The partial AUC of ``max_fpr`` with McClish's
correction stays on the device, as in the JAX package (``auroc.py:77-106``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    ExactState,
    Thresholds,
    _as_tensor,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _dispatch,
    _exact_state,
    _is_binned,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
    _one_vs_rest,
)
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from torchmetrics_tpu_torch.utils import checks
from torchmetrics_tpu_torch.utils.compute import _auc_compute_without_check, _flushed_floor, _safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn


def _reduce_auroc(
    fpr: Union[Tensor, List[Tensor]],
    tpr: Union[Tensor, List[Tensor]],
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Tensor:
    """Per-class trapezoid AUCs and their macro, weighted or no reduction (reference ``auroc.py:51``)."""
    if isinstance(fpr, (list, tuple)):
        res = torch.stack([_auc_compute_without_check(x, y, 1.0) for x, y in zip(fpr, tpr)])
    else:
        res = _auc_compute_without_check(fpr, tpr, 1.0, axis=-1)
    return _reduce_per_class(res, average, weights)


def _reduce_per_class(res: Tensor, average: Optional[str], weights: Optional[Tensor]) -> Tensor:
    """Macro or weighted mean of per-class scores that ignores NaN classes (``auroc.py:51``,
    ``average_precision.py:43``)."""
    if average is None or average == "none":
        return res
    idx = ~torch.isnan(res)
    if not checks.capturing(res) and not bool(idx.all()):  # the warning reads the device
        rank_zero_warn(
            "Average precision score for one or more classes was `nan`. Ignoring these classes in average",
            UserWarning,
        )
    if average == "macro":
        return torch.sum(torch.where(idx, res, 0.0)) / torch.clamp(torch.sum(idx), min=1)
    if average == "weighted" and weights is not None:
        weights = torch.where(idx, weights, 0.0)
        weights = _safe_divide(weights, torch.sum(weights))
        return torch.sum(torch.where(idx, res * weights, 0.0))
    raise ValueError("Received an incompatible combinations of inputs to make reduction.")


def _binary_auroc_arg_validation(
    max_fpr: Optional[float] = None, thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
        raise ValueError(f"Arguments `max_fpr` must be a float in range (0, 1], but got: {max_fpr}")


def _binary_auroc_compute(
    state: Union[Tensor, ExactState], thresholds: Optional[Tensor], max_fpr: Optional[float] = None
) -> Tensor:
    fpr, tpr, _ = _binary_roc_compute(state, thresholds)
    full_auc = _auc_compute_without_check(fpr, tpr, 1.0)
    if max_fpr is None or max_fpr == 1:
        return full_auc
    # partial AUC over [0, max_fpr] with McClish's correction (reference auroc.py:89-107)
    n = fpr.shape[0]
    # no host read and no tensor built from host data, so a CUDA graph can capture it: the scalar
    # goes to searchsorted as it is, and the gathers index on the device
    stop = torch.clamp(torch.searchsorted(fpr, max_fpr, right=True), 1, n - 1).reshape(1)
    f_lo, f_hi = fpr.gather(0, stop - 1)[0], fpr.gather(0, stop)[0]
    t_lo, t_hi = tpr.gather(0, stop - 1)[0], tpr.gather(0, stop)[0]
    weight = (max_fpr - f_lo) / _flushed_floor(f_hi - f_lo)
    interp_tpr = t_lo + weight * (t_hi - t_lo)
    seg_areas = 0.5 * (tpr[1:] + tpr[:-1]) * (fpr[1:] - fpr[:-1])
    seg_mask = torch.arange(n - 1, device=fpr.device) < (stop - 1)
    partial_auc = torch.sum(torch.where(seg_mask, seg_areas, 0.0)) + 0.5 * (t_lo + interp_tpr) * (max_fpr - f_lo)
    min_area = 0.5 * max_fpr**2
    mcclish = 0.5 * (1 + (partial_auc - min_area) / (max_fpr - min_area))
    degenerate = (torch.sum(fpr) == 0) | (torch.sum(tpr) == 0)
    return torch.where(degenerate, full_auc, mcclish).to(torch.float32)


def binary_auroc(
    preds: Tensor,
    target: Tensor,
    max_fpr: Optional[float] = None,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Area under the ROC curve for binary tasks (reference ``auroc.py:112``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds)
    if thresholds is None:
        return _binary_auroc_compute(_exact_state(preds, target, ignore_index), None, max_fpr)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, ignore_index)
    return _binary_auroc_compute(state, thresholds, max_fpr)


def _multiclass_auroc_arg_validation(
    num_classes: int, average: Optional[str] = "macro", thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
    allowed_average = ("macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")


def _binned_support(state: Tensor) -> Tensor:
    """Positives of each class: tp + fn at any threshold of a ``(T, C, 2, 2)`` state."""
    return state[0, :, 1, 1] + state[0, :, 1, 0]


def _multiclass_support(state: Union[Tensor, ExactState], num_classes: int, thresholds: Optional[Tensor]) -> Tensor:
    if _is_binned(state, thresholds):
        return _binned_support(state).to(torch.float32)
    _, target, weight = state
    return torch.sum(_one_vs_rest(target, num_classes) * weight[:, None], dim=0)


def _multilabel_support(state: Union[Tensor, ExactState], thresholds: Optional[Tensor]) -> Tensor:
    if _is_binned(state, thresholds):
        return _binned_support(state).to(torch.float32)
    _, target, weight = state
    return torch.sum(target * weight, dim=0).to(torch.float32)


def _multiclass_auroc_compute(
    state: Union[Tensor, ExactState],
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Optional[Tensor] = None,
) -> Tensor:
    fpr, tpr, _ = _multiclass_roc_compute(state, num_classes, thresholds)
    return _reduce_auroc(fpr, tpr, average, weights=_multiclass_support(state, num_classes, thresholds))


def multiclass_auroc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """One-vs-rest AUROC for multiclass tasks (reference ``auroc.py:194``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_auroc_arg_validation(num_classes, average, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(preds, target, num_classes, thresholds)
    if thresholds is None:
        return _multiclass_auroc_compute(_exact_state(preds, target, ignore_index), num_classes, average, None)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, ignore_index)
    return _multiclass_auroc_compute(state, num_classes, average, thresholds)


def _multilabel_auroc_arg_validation(
    num_labels: int, average: Optional[str], thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average} but got {average}")


def _flat_exact(state: ExactState) -> Tuple[Tensor, Tensor, Tensor]:
    return tuple(x.reshape(-1) for x in state)  # type: ignore[return-value]


def _multilabel_auroc_compute(
    state: Union[Tensor, ExactState],
    num_labels: int,
    average: Optional[str],
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
) -> Tensor:
    if average == "micro":
        if _is_binned(state, thresholds):
            return _binary_auroc_compute(torch.sum(state, dim=1), thresholds, max_fpr=None)
        return _binary_auroc_compute(_flat_exact(state), None, None)
    fpr, tpr, _ = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    return _reduce_auroc(fpr, tpr, average, weights=_multilabel_support(state, thresholds))


def multilabel_auroc(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Per-label AUROC (reference ``auroc.py:322``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_auroc_arg_validation(num_labels, average, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(preds, target, num_labels, thresholds)
    if thresholds is None:
        return _multilabel_auroc_compute(_exact_state(preds, target, ignore_index), num_labels, average, None, ignore_index)
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, ignore_index)
    return _multilabel_auroc_compute(state, num_labels, average, thresholds, ignore_index)


def auroc(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching entry (reference ``auroc.py:471``)."""
    task = _dispatch(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_auroc(preds, target, max_fpr, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_auroc(preds, target, num_classes, average, thresholds, ignore_index, validate_args)
    return multilabel_auroc(preds, target, num_labels, average, thresholds, ignore_index, validate_args)
