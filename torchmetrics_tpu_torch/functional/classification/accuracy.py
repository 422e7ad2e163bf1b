"""Accuracy (counterpart of ``torchmetrics_tpu/functional/classification/accuracy.py``).

``_accuracy_reduce`` (``:31``, reference ``accuracy.py:23-80``), the binary (``:56``), multiclass
and multilabel (``:112``) entries and the task entry ``accuracy`` (``:141``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification._counts import binary_counts, multiclass_counts, multilabel_counts
from torchmetrics_tpu_torch.functional.classification.stat_scores import _check_task
from torchmetrics_tpu_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


def _accuracy_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
) -> Tensor:
    if average == "binary":
        return _safe_divide(tp + tn, tp + tn + fp + fn)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp = torch.sum(tp, dim=dim)
        fn = torch.sum(fn, dim=dim)
        if multilabel:
            fp = torch.sum(fp, dim=dim)
            tn = torch.sum(tn, dim=dim)
            return _safe_divide(tp + tn, tp + tn + fp + fn)
        return _safe_divide(tp, tp + fn)
    score = _safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else _safe_divide(tp, tp + fn)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)


def binary_accuracy(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Binary accuracy (reference ``accuracy.py:84``)."""
    tp, fp, tn, fn = binary_counts(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _accuracy_reduce(tp, fp, tn, fn, average="binary", multidim_average=multidim_average)


def multiclass_accuracy(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multiclass accuracy (reference ``accuracy.py:153``)."""
    tp, fp, tn, fn = multiclass_counts(
        preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
    )
    return _accuracy_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average, top_k=top_k)


def multilabel_accuracy(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Multilabel accuracy (reference ``accuracy.py:233``)."""
    tp, fp, tn, fn = multilabel_counts(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
    return _accuracy_reduce(tp, fp, tn, fn, average=average, multidim_average=multidim_average, multilabel=True)


def accuracy(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching accuracy (reference ``accuracy.py:315``)."""
    task = _check_task(task, num_classes, num_labels, top_k)
    if task == ClassificationTask.BINARY:
        return binary_accuracy(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_accuracy(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    return multilabel_accuracy(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
