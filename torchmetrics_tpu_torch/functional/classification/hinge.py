"""Hinge loss (counterpart of ``torchmetrics_tpu/functional/classification/hinge.py``).

Binary (``:50-66``): sigmoid where the scores are logits, then the margin against a ±1 target.
Multiclass (``:129-160``): softmax where needed; ``crammer-singer`` holds the true class's score
against the best other score under a ``-inf`` mask, ``one-vs-all`` takes a binary hinge per class
and keeps a ``(C,)`` sum. Every loss is a float32 sum weighted by the ignore mask, with a float32
weight total. The value checks read the device once, before any captured step.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import _as_tensor, _value_range
from torchmetrics_tpu_torch.utils.checks import _check_binary_target, _check_same_shape
from torchmetrics_tpu_torch.utils.compute import _safe_divide, normalize_logits_if_needed
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


def _hinge_loss_update(measures: Tensor, weight: Tensor) -> Tuple[Tensor, Tensor]:
    return torch.sum(measures * weight, dim=0), torch.sum(weight)


def _hinge_loss_compute(measure: Tensor, total: Tensor) -> Tensor:
    return _safe_divide(measure, total)


def _binary_hinge_loss_arg_validation(squared: bool, ignore_index: Optional[int] = None) -> None:
    if not isinstance(squared, bool):
        raise ValueError(f"Argument `squared` must be an bool but got {squared}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Argument `ignore_index` must be either `None` or an integer, but got {ignore_index}")


def _binary_hinge_loss_tensor_validation(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> None:
    _check_same_shape(preds, target)
    if not preds.is_floating_point():
        raise ValueError(
            "Expected argument `preds` to be floating tensor with probabilities/logits"
            f" but got tensor with dtype {preds.dtype}"
        )
    _check_binary_target(target, ignore_index)


def _weights(target: Tensor, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor]:
    """The float32 ignore mask, and the target with its ignored entries set to 0."""
    if ignore_index is None:
        return torch.ones(target.shape, dtype=torch.float32, device=target.device), target
    ignored = target == ignore_index
    return (~ignored).to(torch.float32), target.masked_fill(ignored, 0)


def _hinge(margin: Tensor, squared: bool) -> Tensor:
    measures = torch.clamp(1 - margin, min=0.0)
    return measures**2 if squared else measures


def _binary_hinge_update(
    preds: Tensor, target: Tensor, squared: bool, ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    preds = normalize_logits_if_needed(preds.reshape(-1), "sigmoid")
    weight, target = _weights(target.reshape(-1), ignore_index)
    target_pm = target.to(torch.float32) * 2 - 1  # {0,1} -> {-1,+1}
    return _hinge_loss_update(_hinge(preds * target_pm, squared), weight)


def binary_hinge_loss(preds: Tensor, target: Tensor, squared: bool = False, ignore_index: Optional[int] = None,
                      validate_args: bool = True) -> Tensor:
    """Mean hinge loss of a binary task (reference ``hinge.py:96``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import binary_hinge_loss
        >>> print(f"{float(binary_hinge_loss(torch.tensor([0.9, 0.1, 0.8, 0.4]), torch.tensor([1, 0, 1, 1]))):.4f}")
        0.5000
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_hinge_loss_arg_validation(squared, ignore_index)
        _binary_hinge_loss_tensor_validation(preds, target, ignore_index)
    measure, total = _binary_hinge_update(preds, target, squared, ignore_index)
    return _hinge_loss_compute(measure, total)


def _multiclass_hinge_loss_arg_validation(
    num_classes: int, squared: bool = False, multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Argument `num_classes` must be an integer larger than 1, but got {num_classes}")
    _binary_hinge_loss_arg_validation(squared, ignore_index)
    if multiclass_mode not in ("crammer-singer", "one-vs-all"):
        raise ValueError(
            f"Expected argument `multiclass_mode` to be one of 'crammer-singer', 'one-vs-all',"
            f" but got {multiclass_mode}"
        )


def _multiclass_hinge_loss_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    if preds.ndim != target.ndim + 1:
        raise ValueError("Expected `preds` to have one more dimension than `target`")
    if not preds.is_floating_point():
        raise ValueError(f"`preds` must be a float tensor, but got {preds.dtype}")
    if preds.shape[1] != num_classes:
        raise ValueError(f"Expected `preds.shape[1]={preds.shape[1]}` to equal num_classes {num_classes}")
    t = target if ignore_index is None else target[target != ignore_index]
    if t.numel():
        lo, hi = _value_range(t)
        if lo < 0 or hi >= num_classes:
            raise RuntimeError(f"Detected values in `target` outside [0, {num_classes})")


def _multiclass_hinge_update(
    preds: Tensor, target: Tensor, num_classes: int, squared: bool, multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    preds = normalize_logits_if_needed(torch.movedim(preds, 1, -1).reshape(-1, num_classes), "softmax")
    weight, target = _weights(target.reshape(-1), ignore_index)
    onehot = target[:, None] == torch.arange(num_classes, device=target.device)[None, :]
    if multiclass_mode == "crammer-singer":
        true_score = torch.sum(preds * onehot.to(torch.float32), dim=-1)
        best_other = torch.amax(preds.masked_fill(onehot, float("-inf")), dim=-1)
        return _hinge_loss_update(_hinge(true_score - best_other, squared), weight)
    # one-vs-all: a binary hinge per class against ±1 targets; a per-class sum
    target_pm = onehot.to(torch.float32) * 2 - 1
    return _hinge_loss_update(_hinge(preds * target_pm, squared), weight[:, None])


def multiclass_hinge_loss(preds: Tensor, target: Tensor, num_classes: int, squared: bool = False,
                          multiclass_mode: str = "crammer-singer", ignore_index: Optional[int] = None,
                          validate_args: bool = True) -> Tensor:
    """Mean hinge loss of a multiclass task (reference ``hinge.py:205``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_hinge_loss_arg_validation(num_classes, squared, multiclass_mode, ignore_index)
        _multiclass_hinge_loss_tensor_validation(preds, target, num_classes, ignore_index)
    measure, total = _multiclass_hinge_update(preds, target, num_classes, squared, multiclass_mode, ignore_index)
    return _hinge_loss_compute(measure, total)


def hinge_loss(preds: Tensor, target: Tensor, task: str, num_classes: Optional[int] = None, squared: bool = False,
               multiclass_mode: str = "crammer-singer", ignore_index: Optional[int] = None,
               validate_args: bool = True) -> Tensor:
    """Task-dispatching hinge loss (reference ``hinge.py:290``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import hinge_loss
        >>> preds, target = torch.tensor([0.25, 0.25, 0.55, 0.75, 0.75]), torch.tensor([0, 0, 1, 1, 1])
        >>> print(f"{float(hinge_loss(preds, target, task='binary')):.4f}")
        0.6900
    """
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_hinge_loss(preds, target, squared, ignore_index, validate_args)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` must be `int` but `{type(num_classes)} was passed.`")
    return multiclass_hinge_loss(preds, target, num_classes, squared, multiclass_mode, ignore_index, validate_args)
