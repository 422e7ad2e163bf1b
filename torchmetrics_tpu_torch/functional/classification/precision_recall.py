"""Precision and recall (counterpart of
``torchmetrics_tpu/functional/classification/precision_recall.py``): ``_precision_recall_reduce``
(``:16``) and the multiclass entry points."""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification._counts import multiclass_counts
from torchmetrics_tpu_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide


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


def multiclass_precision(preds, target, num_classes: int, average: Optional[str] = "macro", top_k: int = 1,
                         multidim_average: str = "global", ignore_index: Optional[int] = None,
                         validate_args: bool = True) -> Tensor:
    """Reference ``precision_recall.py:146``."""
    tp, fp, tn, fn = multiclass_counts(preds, target, num_classes, average, top_k, multidim_average,
                                       ignore_index, validate_args)
    return _precision_recall_reduce("precision", tp, fp, tn, fn, average, multidim_average, top_k=top_k)


def multiclass_recall(preds, target, num_classes: int, average: Optional[str] = "macro", top_k: int = 1,
                      multidim_average: str = "global", ignore_index: Optional[int] = None,
                      validate_args: bool = True) -> Tensor:
    """Reference ``precision_recall.py:383``."""
    tp, fp, tn, fn = multiclass_counts(preds, target, num_classes, average, top_k, multidim_average,
                                       ignore_index, validate_args)
    return _precision_recall_reduce("recall", tp, fp, tn, fn, average, multidim_average, top_k=top_k)
