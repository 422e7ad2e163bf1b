"""Calibration error (counterpart of ``torchmetrics_tpu/functional/classification/calibration_error.py``).

As in the JAX package, the state is three ``(n_bins + 1,)`` float32 sums (count, confidence and
accuracy per bin) against a fixed uniform grid; the extra slot holds ``conf == 1.0``. Two things
keep the port's bins equal to JAX's:

- the grid is built bit-equal to ``jnp.linspace(0, 1, n_bins + 1, dtype=float32)``
  (:func:`_boundaries`): ``torch.linspace`` differs from it at most ``n_bins`` between 1 and 300,
  and a confidence on a boundary would then change bins;
- the per-bin sums are the same cumulative-indicator product (``:40-42``), run in float64 and
  cast into the float32 state, so that a caller's ``torch.set_float32_matmul_precision("high")``
  cannot turn it into TF32.
"""
from __future__ import annotations

import functools

from typing import Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import _as_tensor, _value_range
from torchmetrics_tpu_torch.utils.checks import _check_binary_target, _check_same_shape
from torchmetrics_tpu_torch.utils.compute import _safe_divide, normalize_logits_if_needed
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel


@functools.lru_cache(maxsize=None)
def _boundaries(n_bins: int, device: torch.device) -> Tensor:
    """float32 ``(n_bins + 1,)`` bin edges bit-equal to ``jnp.linspace(0, 1, n_bins + 1, dtype=float32)``:
    ``k * float32(1 / n_bins)`` rounded to float32, with the last edge exactly 1.0.

    Built once per grid and device, and never written: an update copies no grid from the host,
    so a CUDA graph can capture it."""
    edges = np.arange(n_bins + 1, dtype=np.float32) * np.float32(1.0 / n_bins)
    edges[-1] = 1.0
    return torch.from_numpy(edges).to(device)


def _binning_bucketize(
    confidences: Tensor, accuracies: Tensor, weight: Tensor, n_bins: int
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-bin float32 (count, conf_sum, acc_sum) against the uniform grid (``:22-47``).

    A value on a boundary goes to the upper bin and ``conf == 1.0`` to the extra slot, as the
    reference's ``bucketize(conf, linspace(0, 1, n_bins + 1), right=True) - 1`` places them; a
    value below 0 or a NaN counts in no bin. ``suffix[k] = Σ x_i·[c_i >= b_k]`` is one float64
    product, and bin k is ``suffix[k] - suffix[k + 1]``.
    """
    edges = _boundaries(n_bins, confidences.device)
    ind = (confidences[:, None] >= edges[None, :]).to(torch.float64)  # (N, B+1)
    w = weight.to(torch.float64)
    stacked = torch.stack([w, confidences.to(torch.float64) * w, accuracies.to(torch.float64) * w])  # (3, N)
    suffix = stacked @ ind  # (3, B+1)
    sums = torch.cat([suffix[:, :-1] - suffix[:, 1:], suffix[:, -1:]], dim=1).to(torch.float32)
    return sums[0], sums[1], sums[2]


def _ce_compute(count: Tensor, conf_sum: Tensor, acc_sum: Tensor, norm: str = "l1") -> Tensor:
    """Expected (l1), root-mean-square (l2) or maximum calibration error from per-bin sums
    (reference ``calibration_error.py:72``)."""
    prop = _safe_divide(count, count.sum())
    gap = torch.abs(_safe_divide(acc_sum, count) - _safe_divide(conf_sum, count))
    if norm == "l1":
        return torch.sum(gap * prop)
    if norm == "l2":
        return torch.sqrt(torch.clamp_min(torch.sum(gap**2 * prop), 0.0))
    if norm == "max":
        return torch.max(torch.where(count > 0, gap, 0.0))
    raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")


def _binary_calibration_error_arg_validation(n_bins: int, norm: str = "l1", ignore_index: Optional[int] = None) -> None:
    if not isinstance(n_bins, int) or n_bins < 1:
        raise ValueError(f"Argument `n_bins` must be an integer larger than 0, but got {n_bins}")
    if norm not in ("l1", "l2", "max"):
        raise ValueError(f"Argument `norm` is expected to be one of 'l1', 'l2', 'max' but got {norm}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Argument `ignore_index` must be either `None` or an integer, but got {ignore_index}")


def _binary_calibration_error_tensor_validation(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> None:
    _check_same_shape(preds, target)
    if not preds.is_floating_point():
        raise ValueError(f"Expected argument `preds` to be floating tensor, but got {preds.dtype}")
    _check_binary_target(target, ignore_index)


def _weights(target: Tensor, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor]:
    """float32 weight 0 on ``ignore_index`` entries, 1 elsewhere, and the target with those entries at 0."""
    if ignore_index is None:
        return target, torch.ones(target.shape, dtype=torch.float32, device=target.device)
    ignored = target == ignore_index
    return torch.where(ignored, 0, target), (~ignored).to(torch.float32)


def _binary_confidences_accuracies(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    preds = normalize_logits_if_needed(preds.reshape(-1), "sigmoid")
    target, weight = _weights(target.reshape(-1), ignore_index)
    positive = preds > 0.5
    confidences = torch.where(positive, preds, 1 - preds)
    accuracies = (positive.to(torch.int64) == target).to(torch.float32)
    return confidences, accuracies, weight


def binary_calibration_error(
    preds: Tensor,
    target: Tensor,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Top-label calibration error, binary (reference ``calibration_error.py:129``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)
        _binary_calibration_error_tensor_validation(preds, target, ignore_index)
    confidences, accuracies, weight = _binary_confidences_accuracies(preds, target, ignore_index)
    return _ce_compute(*_binning_bucketize(confidences, accuracies, weight, n_bins), norm)


def _multiclass_calibration_error_arg_validation(
    num_classes: int, n_bins: int, norm: str = "l1", ignore_index: Optional[int] = None
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Argument `num_classes` must be an integer larger than 1, but got {num_classes}")
    _binary_calibration_error_arg_validation(n_bins, norm, ignore_index)


def _multiclass_calibration_error_tensor_validation(
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


def _multiclass_confidences_accuracies(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    preds = normalize_logits_if_needed(torch.movedim(preds, 1, -1).reshape(-1, num_classes), "softmax")
    target, weight = _weights(target.reshape(-1), ignore_index)
    accuracies = (torch.argmax(preds, dim=-1) == target).to(torch.float32)  # the first maximum, as in JAX
    return preds.max(dim=-1).values, accuracies, weight


def multiclass_calibration_error(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Top-label calibration error, multiclass (reference ``calibration_error.py:263``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_calibration_error_arg_validation(num_classes, n_bins, norm, ignore_index)
        _multiclass_calibration_error_tensor_validation(preds, target, num_classes, ignore_index)
    confidences, accuracies, weight = _multiclass_confidences_accuracies(preds, target, num_classes, ignore_index)
    return _ce_compute(*_binning_bucketize(confidences, accuracies, weight, n_bins), norm)


def calibration_error(
    preds: Tensor,
    target: Tensor,
    task: str,
    n_bins: int = 15,
    norm: str = "l1",
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching entry (reference ``calibration_error.py:390``)."""
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_calibration_error(preds, target, n_bins, norm, ignore_index, validate_args)
    if not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` must be `int` but `{type(num_classes)} was passed.`")
    return multiclass_calibration_error(preds, target, num_classes, n_bins, norm, ignore_index, validate_args)
