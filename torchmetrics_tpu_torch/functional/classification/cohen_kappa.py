"""Cohen's kappa (counterpart of ``torchmetrics_tpu/functional/classification/cohen_kappa.py``).

``_cohen_kappa_reduce`` (``:19``) reduces the confusion matrix, counted by K1 on the card. The
expected matrix ``sum1 @ sum0 / sum(sum0)`` (``:24``) is an outer product with K = 1: here a
broadcast multiply, one float32 rounding per entry as in JAX, which a global TF32 setting cannot
reach as it could a ``torch.matmul``. The weights are none, ``linear`` or ``quadratic``
(``:27-31``). Then the binary (``:46``), multiclass (``:56``) and task (``:66``) entries.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_arg_validation,
    binary_confusion_matrix,
    multiclass_confusion_matrix,
)
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


def _cohen_kappa_reduce(confmat: Tensor, weights: Optional[str] = None) -> Tensor:
    confmat = confmat.to(torch.float32)
    num_classes = confmat.shape[0]
    sum0 = torch.sum(confmat, dim=0, keepdim=True)
    sum1 = torch.sum(confmat, dim=1, keepdim=True)
    expected = sum1 * sum0 / torch.sum(sum0)

    if weights is None or weights == "none":
        w_mat = 1.0 - torch.eye(num_classes, dtype=confmat.dtype, device=confmat.device)
    elif weights in ("linear", "quadratic"):
        idx = torch.arange(num_classes, dtype=confmat.dtype, device=confmat.device)
        diff = idx[:, None] - idx[None, :]
        w_mat = torch.abs(diff) if weights == "linear" else diff**2
    else:
        raise ValueError(
            f"Received {weights} for argument ``weights`` but should be either None, 'linear' or 'quadratic'"
        )
    k = torch.sum(w_mat * confmat) / torch.sum(w_mat * expected)
    return 1 - k


def _validate_weights(weights: Optional[str]) -> None:
    allowed_weights = ("linear", "quadratic", "none", None)
    if weights not in allowed_weights:
        raise ValueError(f"Expected argument `weight` to be one of {allowed_weights}, but got {weights}.")


def binary_cohen_kappa(preds: Tensor, target: Tensor, threshold: float = 0.5, weights: Optional[str] = None,
                       ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Binary Cohen's kappa (reference ``cohen_kappa.py:75``)."""
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
        _validate_weights(weights)
    confmat = binary_confusion_matrix(preds, target, threshold, None, ignore_index, validate_args)
    return _cohen_kappa_reduce(confmat, weights)


def multiclass_cohen_kappa(preds: Tensor, target: Tensor, num_classes: int, weights: Optional[str] = None,
                           ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Multiclass Cohen's kappa (reference ``cohen_kappa.py:157``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_cohen_kappa
        >>> print(f"{float(multiclass_cohen_kappa(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]), 3)):.4f}")
        0.6364
    """
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
        _validate_weights(weights)
    confmat = multiclass_confusion_matrix(preds, target, num_classes, None, ignore_index, validate_args)
    return _cohen_kappa_reduce(confmat, weights)


def cohen_kappa(preds: Tensor, target: Tensor, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
                weights: Optional[str] = None, ignore_index: Optional[int] = None,
                validate_args: bool = True) -> Tensor:
    """Task-dispatching Cohen's kappa (reference ``cohen_kappa.py:250``)."""
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_cohen_kappa(preds, target, threshold, weights, ignore_index, validate_args)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` must be `int` but `{type(num_classes)} was passed.`")
    return multiclass_cohen_kappa(preds, target, num_classes, weights, ignore_index, validate_args)
