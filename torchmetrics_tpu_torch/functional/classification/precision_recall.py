"""Precision and recall (counterpart of
``torchmetrics_tpu/functional/classification/precision_recall.py``): ``_precision_recall_reduce``
(``:16``), the binary, multiclass and multilabel entries (``:39-106``) and the task entries
``precision`` and ``recall`` (``:109-164``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification._counts import binary_counts, multiclass_counts, multilabel_counts
from torchmetrics_tpu_torch.functional.classification.stat_scores import _check_task
from torchmetrics_tpu_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


def _precision_recall_reduce(
    stat: str,
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
    zero_division: float = 0.0,
) -> Tensor:
    different_stat = fp if stat == "precision" else fn  # this is what differs between the two
    if average == "binary":
        return _safe_divide(tp, tp + different_stat, zero_division)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp = torch.sum(tp, dim=dim)
        different_stat = torch.sum(different_stat, dim=dim)
        return _safe_divide(tp, tp + different_stat, zero_division)
    score = _safe_divide(tp, tp + different_stat, zero_division)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)


def binary_precision(preds, target, threshold: float = 0.5, multidim_average: str = "global",
                     ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Reference ``precision_recall.py:79``."""
    tp, fp, tn, fn = binary_counts(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _precision_recall_reduce("precision", tp, fp, tn, fn, "binary", multidim_average)


def multiclass_precision(preds, target, num_classes: int, average: Optional[str] = "macro", top_k: int = 1,
                         multidim_average: str = "global", ignore_index: Optional[int] = None,
                         validate_args: bool = True) -> Tensor:
    """Reference ``precision_recall.py:146``."""
    tp, fp, tn, fn = multiclass_counts(preds, target, num_classes, average, top_k, multidim_average,
                                       ignore_index, validate_args)
    return _precision_recall_reduce("precision", tp, fp, tn, fn, average, multidim_average, top_k=top_k)


def multilabel_precision(preds, target, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
                         multidim_average: str = "global", ignore_index: Optional[int] = None,
                         validate_args: bool = True) -> Tensor:
    """Reference ``precision_recall.py:231``."""
    tp, fp, tn, fn = multilabel_counts(preds, target, num_labels, threshold, average, multidim_average,
                                       ignore_index, validate_args)
    return _precision_recall_reduce("precision", tp, fp, tn, fn, average, multidim_average, multilabel=True)


def binary_recall(preds, target, threshold: float = 0.5, multidim_average: str = "global",
                  ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Reference ``precision_recall.py:316``."""
    tp, fp, tn, fn = binary_counts(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _precision_recall_reduce("recall", tp, fp, tn, fn, "binary", multidim_average)


def multiclass_recall(preds, target, num_classes: int, average: Optional[str] = "macro", top_k: int = 1,
                      multidim_average: str = "global", ignore_index: Optional[int] = None,
                      validate_args: bool = True) -> Tensor:
    """Reference ``precision_recall.py:383``."""
    tp, fp, tn, fn = multiclass_counts(preds, target, num_classes, average, top_k, multidim_average,
                                       ignore_index, validate_args)
    return _precision_recall_reduce("recall", tp, fp, tn, fn, average, multidim_average, top_k=top_k)


def multilabel_recall(preds, target, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
                      multidim_average: str = "global", ignore_index: Optional[int] = None,
                      validate_args: bool = True) -> Tensor:
    """Reference ``precision_recall.py:468``."""
    tp, fp, tn, fn = multilabel_counts(preds, target, num_labels, threshold, average, multidim_average,
                                       ignore_index, validate_args)
    return _precision_recall_reduce("recall", tp, fp, tn, fn, average, multidim_average, multilabel=True)


def _task_entry(stat: str, preds, target, task: str, threshold: float, num_classes: Optional[int],
                num_labels: Optional[int], average: Optional[str], multidim_average: str, top_k: int,
                ignore_index: Optional[int], validate_args: bool) -> Tensor:
    """The body of ``precision`` and ``recall``: the task's entry for ``stat``."""
    task = _check_task(task, num_classes, num_labels, top_k)
    binary, multiclass, multilabel = _ENTRIES[stat]
    if task == ClassificationTask.BINARY:
        return binary(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass(preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args)
    return multilabel(preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args)


_ENTRIES = {
    "precision": (binary_precision, multiclass_precision, multilabel_precision),
    "recall": (binary_recall, multiclass_recall, multilabel_recall),
}


def precision(preds, target, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
              num_labels: Optional[int] = None, average: Optional[str] = "micro", multidim_average: str = "global",
              top_k: int = 1, ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Task-dispatching precision (reference ``precision_recall.py:553``)."""
    return _task_entry("precision", preds, target, task, threshold, num_classes, num_labels, average,
                       multidim_average, top_k, ignore_index, validate_args)


def recall(preds, target, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
           num_labels: Optional[int] = None, average: Optional[str] = "micro", multidim_average: str = "global",
           top_k: int = 1, ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Task-dispatching recall (reference ``precision_recall.py:625``)."""
    return _task_entry("recall", preds, target, task, threshold, num_classes, num_labels, average,
                       multidim_average, top_k, ignore_index, validate_args)
