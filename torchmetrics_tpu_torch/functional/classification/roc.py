"""ROC curves (counterpart of ``torchmetrics_tpu/functional/classification/roc.py``).

Shares the precision-recall-curve state (binned ``(T, ..., 2, 2)`` confusion counts, or exact
score lists); only the finalisation differs.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    ExactState,
    Thresholds,
    _as_tensor,
    _binary_clf_curve_exact,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _class_positives,
    _dispatch,
    _exact_curves,
    _f32,
    _host,
    _is_binned,
    _label_positives,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.utils.compute import _safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn


def _roc_from_confmat(confmat: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """``(..., T, 2, 2)`` → ``(fpr, tpr, thresholds)`` with thresholds flipped to descending."""
    tps = confmat[..., 1, 1]
    fps = confmat[..., 0, 1]
    fns = confmat[..., 1, 0]
    tns = confmat[..., 0, 0]
    tpr = torch.flip(_safe_divide(tps, tps + fns), dims=(-1,))
    fpr = torch.flip(_safe_divide(fps, fps + tns), dims=(-1,))
    return fpr, tpr, torch.flip(thresholds.to(confmat.device), dims=(-1,))


def _roc_from_exact(
    preds: np.ndarray, target: np.ndarray, weight: np.ndarray, device: torch.device
) -> Tuple[Tensor, Tensor, Tensor]:
    fps, tps, thres = _binary_clf_curve_exact(preds, target, weight)
    tps = np.hstack([0.0, tps])  # the curve starts at (0, 0)
    fps = np.hstack([0.0, fps])
    thres = np.hstack([thres[0] + 1.0, thres])
    if fps[-1] <= 0:
        rank_zero_warn(
            "No negative samples in targets, the false-positive rate here is meaningless. Returning zero tensor in"
            " false positive score",
            UserWarning,
        )
        fpr = np.zeros_like(thres)
    else:
        fpr = fps / fps[-1]
    if tps[-1] <= 0:
        rank_zero_warn(
            "No positive samples in targets, the true-positive rate here is meaningless. Returning zero tensor in"
            " true positive score",
            UserWarning,
        )
        tpr = np.zeros_like(thres)
    else:
        tpr = tps / tps[-1]
    return _f32(fpr, device), _f32(tpr, device), _f32(thres, device)


def _binary_roc_compute(
    state: Union[Tensor, ExactState], thresholds: Optional[Tensor]
) -> Tuple[Tensor, Tensor, Tensor]:
    if _is_binned(state, thresholds):
        return _roc_from_confmat(state, thresholds)
    return _roc_from_exact(*_host(state))


def binary_roc(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """ROC curve for binary tasks (reference ``roc.py:92``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, weight, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    if thresholds is None:
        return _binary_roc_compute((preds, target, weight), None)
    state = _binary_precision_recall_curve_update(preds, target, weight, thresholds)
    return _binary_roc_compute(state, thresholds)


def _multiclass_roc_compute(
    state: Union[Tensor, ExactState],
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
):
    if average == "micro":
        return _binary_roc_compute(state, thresholds)
    if _is_binned(state, thresholds):
        return _roc_from_confmat(torch.movedim(state, 0, 1), thresholds)  # (C, T, 2, 2)
    return _exact_curves(state, num_classes, _class_positives, _roc_from_exact)


def multiclass_roc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """One-vs-rest ROC curves (reference ``roc.py:162``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, weight, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    if average == "micro":
        if thresholds is None:
            return _binary_roc_compute((preds, target, weight), None)
        state = _binary_precision_recall_curve_update(preds, target, weight, thresholds)
        return _binary_roc_compute(state, thresholds)
    if thresholds is None:
        return _multiclass_roc_compute((preds, target, weight), num_classes, None, average)
    state = _multiclass_precision_recall_curve_update(preds, target, weight, num_classes, thresholds)
    return _multiclass_roc_compute(state, num_classes, thresholds, average)


def _multilabel_roc_compute(
    state: Union[Tensor, ExactState],
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
):
    if _is_binned(state, thresholds):
        return _roc_from_confmat(torch.movedim(state, 0, 1), thresholds)
    return _exact_curves(state, num_labels, _label_positives, _roc_from_exact)


def multilabel_roc(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Per-label ROC curves (reference ``roc.py:310``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, weight, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    if thresholds is None:
        return _multilabel_roc_compute((preds, target, weight), num_labels, None, ignore_index)
    state = _multilabel_precision_recall_curve_update(preds, target, weight, num_labels, thresholds)
    return _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)


def roc(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatching entry (reference ``roc.py:470``)."""
    task = _dispatch(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_roc(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_roc(preds, target, num_classes, thresholds, average, ignore_index, validate_args)
    return multilabel_roc(preds, target, num_labels, thresholds, ignore_index, validate_args)
