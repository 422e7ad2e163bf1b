"""Confusion matrices (counterpart of ``torchmetrics_tpu/functional/classification/confusion_matrix.py``).

Every count runs through kernel K1 on a CUDA tensor, in one launch: binary and multiclass through
the confusion entry over ``target * C + pred`` (at C = 1000 the kernel takes its global branch),
multilabel through one bincount over the fused index ``4 * label + 2 * target + pred``, shared
with the multilabel stat scores. ``ignore_index`` is applied inside the count. Counts are int64
(the JAX package's are int32; the values are equal); ``normalize`` gives float32 with NaN set
to 0, as in JAX.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    CountType,
    _as_index,
    _as_tensor,
    _binary_counts,
    _binary_labels,
    _check_task,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_format,
)
from torchmetrics_tpu_torch.ops.histogram import confusion_matrix_update
from torchmetrics_tpu_torch.utils.checks import _check_binary_target, _check_same_shape
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

_ALLOWED_NORMALIZE = ("true", "pred", "all", "none", None)


def _validate_normalize(normalize: Optional[str]) -> None:
    if normalize not in _ALLOWED_NORMALIZE:
        raise ValueError(f"Argument `normalize` needs to one of the following: {_ALLOWED_NORMALIZE}")


def _validate_ignore_index(ignore_index: Optional[int]) -> None:
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Argument `ignore_index` must be either `None` or an integer, but got {ignore_index}")


def _confusion_matrix_reduce(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    """Normalise over true, pred or all (reference ``confusion_matrix.py:35-61``)."""
    _validate_normalize(normalize)
    if normalize is None or normalize == "none":
        return confmat
    confmat = confmat.to(torch.float32)
    if normalize == "true":
        cm = confmat / confmat.sum(dim=-1, keepdim=True)
    elif normalize == "pred":
        cm = confmat / confmat.sum(dim=-2, keepdim=True)
    else:
        cm = confmat / confmat.sum(dim=(-2, -1), keepdim=True)
    return torch.nan_to_num(cm, nan=0.0)


# --------------------------------------------------------------------- binary
def _binary_confusion_matrix_arg_validation(
    threshold: float = 0.5, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Argument `threshold` must be a float in the [0,1] range, but got {threshold}.")
    _validate_ignore_index(ignore_index)
    _validate_normalize(normalize)


def _binary_confusion_matrix_tensor_validation(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> None:
    _check_same_shape(preds, target)
    _check_binary_target(target, ignore_index, None if preds.is_floating_point() else preds)


def _binary_confusion_matrix_format(preds: Tensor, target: Tensor, threshold: float = 0.5) -> Tuple[Tensor, Tensor]:
    """→ flat ``(preds01, target)``; the target keeps its ``ignore_index`` entries."""
    return _binary_labels(preds, threshold).reshape(-1), _as_index(target.reshape(-1))


def _binary_confusion_matrix_update(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tensor:
    return confusion_matrix_update(preds, target, 2, ignore_index=ignore_index, dtype=CountType)


def _binary_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def binary_confusion_matrix(
    preds, target, threshold: float = 0.5, normalize: Optional[str] = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """(2, 2) confusion matrix (reference ``confusion_matrix.py:156``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target = _binary_confusion_matrix_format(preds, target, threshold)
    return _binary_confusion_matrix_compute(_binary_confusion_matrix_update(preds, target, ignore_index), normalize)


# ------------------------------------------------------------------ multiclass
def _multiclass_confusion_matrix_arg_validation(
    num_classes: int, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Argument `num_classes` must be an integer larger than 1, but got {num_classes}")
    _validate_ignore_index(ignore_index)
    _validate_normalize(normalize)


def _multiclass_confusion_matrix_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    """The multiclass stat scores' checks at ``multidim_average="global"``, ``top_k=1``."""
    _multiclass_stat_scores_tensor_validation(preds, target, num_classes, "global", ignore_index)


def _multiclass_confusion_matrix_format(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """→ flat ``(labels, target)``: float scores ``(N, C, ...)`` become their argmax labels."""
    if preds.ndim == target.ndim + 1:
        preds = torch.argmax(preds, dim=1)
    return _as_index(preds.reshape(-1)), _as_index(target.reshape(-1))


def _multiclass_confusion_matrix_update(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> Tensor:
    return confusion_matrix_update(preds, target, num_classes, ignore_index=ignore_index, dtype=CountType)


def _multiclass_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multiclass_confusion_matrix(
    preds, target, num_classes: int, normalize: Optional[str] = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """(C, C) confusion matrix, rows = target, columns = prediction (reference ``confusion_matrix.py:286``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target = _multiclass_confusion_matrix_format(preds, target)
    confmat = _multiclass_confusion_matrix_update(preds, target, num_classes, ignore_index)
    return _multiclass_confusion_matrix_compute(confmat, normalize)


# ------------------------------------------------------------------ multilabel
def _multilabel_confusion_matrix_arg_validation(
    num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None, normalize: Optional[str] = None
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Argument `num_labels` must be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Argument `threshold` must be a float, but got {threshold}.")
    _validate_ignore_index(ignore_index)
    _validate_normalize(normalize)


def _multilabel_confusion_matrix_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(
            f"Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
            f" but got {preds.shape[1]} and expected {num_labels}"
        )
    _check_binary_target(target, ignore_index)


def _multilabel_confusion_matrix_format(
    preds: Tensor, target: Tensor, num_labels: int, threshold: float = 0.5
) -> Tuple[Tensor, Tensor]:
    """→ ``(preds01, target)``, both ``(N, L, S)``, as the multilabel stat scores format them."""
    return _multilabel_stat_scores_format(preds, target, num_labels, threshold)


def _multilabel_confusion_matrix_update(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> Tensor:
    """(L, 2, 2) per-label confusion matrices, ``[label, target, pred]``, one K1 launch."""
    labels = torch.arange(num_labels, device=target.device)[None, :, None]
    return _binary_counts(preds, target, labels, num_labels, ignore_index)


def _multilabel_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multilabel_confusion_matrix(
    preds, target, num_labels: int, threshold: float = 0.5, normalize: Optional[str] = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """(L, 2, 2) confusion matrices (reference ``confusion_matrix.py:427``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold)
    confmat = _multilabel_confusion_matrix_update(preds, target, num_labels, ignore_index)
    return _multilabel_confusion_matrix_compute(confmat, normalize)


def confusion_matrix(
    preds, target, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
    num_labels: Optional[int] = None, normalize: Optional[str] = None,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Tensor:
    """Task-dispatching confusion matrix (reference ``confusion_matrix.py:578``)."""
    task = _check_task(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_confusion_matrix(preds, target, threshold, normalize, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_confusion_matrix(preds, target, num_classes, normalize, ignore_index, validate_args)
    return multilabel_confusion_matrix(preds, target, num_labels, threshold, normalize, ignore_index, validate_args)
