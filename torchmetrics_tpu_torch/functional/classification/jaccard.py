"""Jaccard index, or IoU (counterpart of ``torchmetrics_tpu/functional/classification/jaccard.py``).

``_jaccard_index_reduce`` (``:19``) is a reduction of the confusion matrix, counted by K1 on the
card: ``(C, C)`` for binary and multiclass, ``(L, 2, 2)`` for multilabel. It keeps the JAX
package's two rules: the micro denominator drops the ``ignore_index`` class's term (``:42``),
and the macro average gives weight 0 to the ignored class and to classes absent from both
target and preds (``:53-55``). Then the binary (``:59``), multiclass (``:75``), multilabel (``:82``)
and task (``:90``) entries.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    multiclass_confusion_matrix,
    multilabel_confusion_matrix,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import _check_task
from torchmetrics_tpu_torch.utils.compute import _safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


def _jaccard_index_reduce(confmat: Tensor, average: Optional[str], ignore_index: Optional[int] = None) -> Tensor:
    allowed_average = ("binary", "micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    confmat = confmat.to(torch.float32)
    if average == "binary":
        return confmat[1, 1] / (confmat[0, 1] + confmat[1, 0] + confmat[1, 1])

    ignore_index_cond = ignore_index is not None and 0 <= ignore_index < confmat.shape[0]
    multilabel = confmat.ndim == 3
    if multilabel:
        num = confmat[:, 1, 1]
        denom = confmat[:, 1, 1] + confmat[:, 0, 1] + confmat[:, 1, 0]
    else:
        num = torch.diagonal(confmat)
        denom = torch.sum(confmat, dim=0) + torch.sum(confmat, dim=1) - num

    if average == "micro":
        num_s = torch.sum(num)
        denom_s = torch.sum(denom)
        if ignore_index_cond:
            denom_s = denom_s - denom[ignore_index]
        return _safe_divide(num_s, denom_s)

    jaccard = _safe_divide(num, denom)
    if average is None or average == "none":
        return jaccard
    if average == "weighted":
        weights = confmat[:, 1, 1] + confmat[:, 1, 0] if multilabel else torch.sum(confmat, dim=1)
    else:
        weights = torch.ones_like(jaccard)
        if ignore_index_cond:
            weights = weights.masked_fill(torch.arange(weights.shape[0], device=weights.device) == ignore_index, 0.0)
        if not multilabel:
            weights = weights.masked_fill(torch.sum(confmat, dim=1) + torch.sum(confmat, dim=0) == 0, 0.0)
    return torch.sum(weights * jaccard / torch.sum(weights))


def binary_jaccard_index(preds: Tensor, target: Tensor, threshold: float = 0.5, ignore_index: Optional[int] = None,
                         validate_args: bool = True) -> Tensor:
    """Binary Jaccard index (reference ``jaccard.py:97``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_jaccard_index
        >>> print(f"{float(binary_jaccard_index(torch.tensor([0.9, 0.1, 0.8, 0.4]), torch.tensor([1, 0, 1, 1]))):.4f}")
        0.6667
    """
    confmat = binary_confusion_matrix(preds, target, threshold, None, ignore_index, validate_args)
    return _jaccard_index_reduce(confmat, average="binary")


def multiclass_jaccard_index(preds: Tensor, target: Tensor, num_classes: int, average: Optional[str] = "macro",
                             ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Multiclass Jaccard index (reference ``jaccard.py:152``)."""
    confmat = multiclass_confusion_matrix(preds, target, num_classes, None, ignore_index, validate_args)
    return _jaccard_index_reduce(confmat, average=average, ignore_index=ignore_index)


def multilabel_jaccard_index(preds: Tensor, target: Tensor, num_labels: int, threshold: float = 0.5,
                             average: Optional[str] = "macro", ignore_index: Optional[int] = None,
                             validate_args: bool = True) -> Tensor:
    """Multilabel Jaccard index (reference ``jaccard.py:217``)."""
    confmat = multilabel_confusion_matrix(preds, target, num_labels, threshold, None, ignore_index, validate_args)
    return _jaccard_index_reduce(confmat, average=average)


def jaccard_index(preds: Tensor, target: Tensor, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
                  num_labels: Optional[int] = None, average: Optional[str] = "macro",
                  ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Task-dispatching Jaccard index (reference ``jaccard.py:290``)."""
    task = _check_task(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_jaccard_index(preds, target, threshold, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_jaccard_index(preds, target, num_classes, average, ignore_index, validate_args)
    return multilabel_jaccard_index(preds, target, num_labels, threshold, average, ignore_index, validate_args)
