"""Specificity (counterpart of ``torchmetrics_tpu/functional/classification/specificity.py``).

``_specificity_reduce`` (``:15``), the binary (``:30``), multiclass (``:46``) and multilabel
(``:55``) entries and the task entry ``specificity`` (``:64``): a reduction of the tp/fp/tn/fn
counts of ``_counts.py``, so one K1 launch per call on a CUDA tensor (``top_k == 1`` or
multilabel; a multiclass ``top_k > 1`` or ``samplewise`` count is one-hot sums, as in JAX).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification._counts import binary_counts, multiclass_counts, multilabel_counts
from torchmetrics_tpu_torch.functional.classification.stat_scores import _check_task
from torchmetrics_tpu_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


def _specificity_reduce(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor,
    average: Optional[str], multidim_average: str = "global", multilabel: bool = False, top_k: int = 1,
) -> Tensor:
    if average == "binary":
        return _safe_divide(tn, tn + fp)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tn = torch.sum(tn, dim=dim)
        fp = torch.sum(fp, dim=dim)
        return _safe_divide(tn, tn + fp)
    specificity_score = _safe_divide(tn, tn + fp)
    return _adjust_weights_safe_divide(specificity_score, average, multilabel, tp, fp, fn, top_k)


def binary_specificity(preds: Tensor, target: Tensor, threshold: float = 0.5, multidim_average: str = "global",
                       ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Binary specificity (reference ``specificity.py:62``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_specificity
        >>> print(f"{float(binary_specificity(torch.tensor([0.9, 0.1, 0.8, 0.4]), torch.tensor([1, 0, 1, 1]))):.4f}")
        1.0000
    """
    tp, fp, tn, fn = binary_counts(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _specificity_reduce(tp, fp, tn, fn, "binary", multidim_average)


def multiclass_specificity(preds: Tensor, target: Tensor, num_classes: int, average: Optional[str] = "macro",
                           top_k: int = 1, multidim_average: str = "global", ignore_index: Optional[int] = None,
                           validate_args: bool = True) -> Tensor:
    """Multiclass specificity (reference ``specificity.py:129``)."""
    tp, fp, tn, fn = multiclass_counts(preds, target, num_classes, average, top_k, multidim_average,
                                       ignore_index, validate_args)
    return _specificity_reduce(tp, fp, tn, fn, average, multidim_average, top_k=top_k)


def multilabel_specificity(preds: Tensor, target: Tensor, num_labels: int, threshold: float = 0.5,
                           average: Optional[str] = "macro", multidim_average: str = "global",
                           ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Multilabel specificity (reference ``specificity.py:214``)."""
    tp, fp, tn, fn = multilabel_counts(preds, target, num_labels, threshold, average, multidim_average,
                                       ignore_index, validate_args)
    return _specificity_reduce(tp, fp, tn, fn, average, multidim_average, multilabel=True)


def specificity(preds: Tensor, target: Tensor, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
                num_labels: Optional[int] = None, average: Optional[str] = "micro", multidim_average: str = "global",
                top_k: int = 1, ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Task-dispatching specificity (reference ``specificity.py:299``)."""
    task = _check_task(task, num_classes, num_labels, top_k)
    if task == ClassificationTask.BINARY:
        return binary_specificity(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_specificity(preds, target, num_classes, average, top_k, multidim_average,
                                      ignore_index, validate_args)
    return multilabel_specificity(preds, target, num_labels, threshold, average, multidim_average,
                                  ignore_index, validate_args)
