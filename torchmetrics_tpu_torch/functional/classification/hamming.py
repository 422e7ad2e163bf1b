"""Hamming distance (counterpart of ``torchmetrics_tpu/functional/classification/hamming.py``).

``_hamming_distance_reduce`` (``:16``, one minus the accuracy-style reduce), the binary
(``:36``), multiclass (``:52``) and multilabel (``:61``) entries and the task entry
``hamming_distance`` (``:70``), over the tp/fp/tn/fn counts of ``_counts.py`` (K1 on the card).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification._counts import binary_counts, multiclass_counts, multilabel_counts
from torchmetrics_tpu_torch.functional.classification.stat_scores import _check_task
from torchmetrics_tpu_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


def _hamming_distance_reduce(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor,
    average: Optional[str], multidim_average: str = "global", multilabel: bool = False, top_k: int = 1,
) -> Tensor:
    if average == "binary":
        return 1 - _safe_divide(tp + tn, tp + fp + tn + fn)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp = torch.sum(tp, dim=dim)
        fn = torch.sum(fn, dim=dim)
        if multilabel:
            fp = torch.sum(fp, dim=dim)
            tn = torch.sum(tn, dim=dim)
            return 1 - _safe_divide(tp + tn, tp + tn + fp + fn)
        return 1 - _safe_divide(tp, tp + fn)
    score = _safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else _safe_divide(tp, tp + fn)
    return 1 - _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)


def binary_hamming_distance(preds: Tensor, target: Tensor, threshold: float = 0.5, multidim_average: str = "global",
                            ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Binary Hamming distance (reference ``hamming.py:78``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_hamming_distance
        >>> print(f"{float(binary_hamming_distance(torch.tensor([0.9, 0.1, 0.8, 0.4]), torch.tensor([1, 0, 1, 1]))):.4f}")
        0.2500
    """
    tp, fp, tn, fn = binary_counts(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _hamming_distance_reduce(tp, fp, tn, fn, "binary", multidim_average)


def multiclass_hamming_distance(preds: Tensor, target: Tensor, num_classes: int, average: Optional[str] = "macro",
                                top_k: int = 1, multidim_average: str = "global", ignore_index: Optional[int] = None,
                                validate_args: bool = True) -> Tensor:
    """Multiclass Hamming distance (reference ``hamming.py:146``)."""
    tp, fp, tn, fn = multiclass_counts(preds, target, num_classes, average, top_k, multidim_average,
                                       ignore_index, validate_args)
    return _hamming_distance_reduce(tp, fp, tn, fn, average, multidim_average, top_k=top_k)


def multilabel_hamming_distance(preds: Tensor, target: Tensor, num_labels: int, threshold: float = 0.5,
                                average: Optional[str] = "macro", multidim_average: str = "global",
                                ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Multilabel Hamming distance (reference ``hamming.py:231``)."""
    tp, fp, tn, fn = multilabel_counts(preds, target, num_labels, threshold, average, multidim_average,
                                       ignore_index, validate_args)
    return _hamming_distance_reduce(tp, fp, tn, fn, average, multidim_average, multilabel=True)


def hamming_distance(preds: Tensor, target: Tensor, task: str, threshold: float = 0.5,
                     num_classes: Optional[int] = None, num_labels: Optional[int] = None,
                     average: Optional[str] = "micro", multidim_average: str = "global", top_k: int = 1,
                     ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Task-dispatching Hamming distance (reference ``hamming.py:316``)."""
    task = _check_task(task, num_classes, num_labels, top_k)
    if task == ClassificationTask.BINARY:
        return binary_hamming_distance(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_hamming_distance(preds, target, num_classes, average, top_k, multidim_average,
                                           ignore_index, validate_args)
    return multilabel_hamming_distance(preds, target, num_labels, threshold, average, multidim_average,
                                       ignore_index, validate_args)
