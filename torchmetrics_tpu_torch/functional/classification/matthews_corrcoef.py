"""Matthews correlation coefficient (counterpart of
``torchmetrics_tpu/functional/classification/matthews_corrcoef.py``).

``_matthews_corrcoef_reduce`` (``:23-51``) follows the JAX package's float32 formula on the
confusion matrix, counted by K1 on the card; the multilabel form sums the per-label 2x2 matrices
first (``:24``). The binary edge cases (``:38-49``: the fallback with ``sqrt(eps)`` where the
denominator is 0, and the +1 / -1 overrides) are ``torch.where`` and ``masked_fill`` selections,
with no branch on the host, so the reduce runs inside a captured step. Nothing is widened to
float64: the port agrees with the JAX package, not with a more exact value.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    multiclass_confusion_matrix,
    multilabel_confusion_matrix,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import _check_task
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

_EPS = float(np.finfo(np.float32).eps)
#: ``jnp.sqrt`` of the float32 eps, rounded once in float32 as the JAX package rounds it
_SQRT_EPS = float(np.sqrt(np.float32(_EPS)))


def _matthews_corrcoef_reduce(confmat: Tensor) -> Tensor:
    confmat = torch.sum(confmat, dim=0) if confmat.ndim == 3 else confmat  # multilabel -> binary
    confmat = confmat.to(torch.float32)

    tk = torch.sum(confmat, dim=-1)
    pk = torch.sum(confmat, dim=-2)
    c = torch.trace(confmat)
    s = torch.sum(confmat)

    cov_ytyp = c * s - torch.sum(tk * pk)
    cov_ypyp = s**2 - torch.sum(pk * pk)
    cov_ytyt = s**2 - torch.sum(tk * tk)
    denom = cov_ypyp * cov_ytyt
    zero = denom == 0

    if confmat.numel() == 4:  # binary edge cases (reference matthews_corrcoef.py:46-74)
        tn, fp, fn, tp = confmat.reshape(-1).unbind()
        a = (tp + tn).masked_fill(~((tp == 0) | (tn == 0)), 0.0)
        b = (fp + fn).masked_fill(~((fp == 0) | (fn == 0)), 0.0)
        fallback_num = _SQRT_EPS * (a - b)
        fallback_denom = (tp + fp + _EPS) * (tp + fn + _EPS) * (tn + fp + _EPS) * (tn + fn + _EPS)
        numerator = torch.where(zero, fallback_num, cov_ytyp)
        denominator = torch.where(zero, fallback_denom, denom)
        res = numerator / torch.sqrt(denominator)
        res = res.masked_fill((tp + tn != 0) & (fp + fn == 0), 1.0)
        return res.masked_fill((tp + tn == 0) & (fp + fn != 0), -1.0)
    return (cov_ytyp / torch.sqrt(denom.masked_fill(zero, 1.0))).masked_fill(zero, 0.0)


def binary_matthews_corrcoef(preds: Tensor, target: Tensor, threshold: float = 0.5,
                             ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Binary MCC (reference ``matthews_corrcoef.py:82``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_matthews_corrcoef
        >>> print(f"{float(binary_matthews_corrcoef(torch.tensor([0.9, 0.1, 0.8, 0.4]), torch.tensor([1, 0, 1, 1]))):.4f}")
        0.5774
    """
    confmat = binary_confusion_matrix(preds, target, threshold, None, ignore_index, validate_args)
    return _matthews_corrcoef_reduce(confmat)


def multiclass_matthews_corrcoef(preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None,
                                 validate_args: bool = True) -> Tensor:
    """Multiclass MCC (reference ``matthews_corrcoef.py:143``)."""
    confmat = multiclass_confusion_matrix(preds, target, num_classes, None, ignore_index, validate_args)
    return _matthews_corrcoef_reduce(confmat)


def multilabel_matthews_corrcoef(preds: Tensor, target: Tensor, num_labels: int, threshold: float = 0.5,
                                 ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Multilabel MCC (reference ``matthews_corrcoef.py:209``)."""
    confmat = multilabel_confusion_matrix(preds, target, num_labels, threshold, None, ignore_index, validate_args)
    return _matthews_corrcoef_reduce(confmat)


def matthews_corrcoef(preds: Tensor, target: Tensor, task: str, threshold: float = 0.5,
                      num_classes: Optional[int] = None, num_labels: Optional[int] = None,
                      ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Task-dispatching MCC (reference ``matthews_corrcoef.py:276``)."""
    task = _check_task(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_matthews_corrcoef(preds, target, threshold, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_matthews_corrcoef(preds, target, num_classes, ignore_index, validate_args)
    return multilabel_matthews_corrcoef(preds, target, num_labels, threshold, ignore_index, validate_args)
