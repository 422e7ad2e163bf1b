"""MAPE, SMAPE and weighted MAPE (counterpart of ``torchmetrics_tpu/functional/regression/mape.py``)."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.utils import _as_float, _check_same_shape, _num_obs

_EPS = 1.17e-06  # the reference's epsilon for zero-denominator clamping


def _mean_abs_percentage_error_update(preds: Tensor, target: Tensor, epsilon: float = _EPS) -> Tuple[Tensor, Tensor]:
    """(Σ|ŷ-y| / max(|y|, ε), n) (``mape.py:15``)."""
    preds, target = _as_float(preds, target)
    abs_per_error = torch.abs(preds - target) / torch.clamp(torch.abs(target), min=epsilon)
    return torch.sum(abs_per_error), _num_obs(target.numel(), target)


def _mean_abs_percentage_error_compute(sum_abs_per_error: Tensor, num_obs: Tensor) -> Tensor:
    return sum_abs_per_error / num_obs


def mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """MAPE (``mape.py:29``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mean_absolute_percentage_error
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> print(f"{float(mean_absolute_percentage_error(preds, target)):.4f}")
        0.3274
    """
    _check_same_shape(preds, target)
    return _mean_abs_percentage_error_compute(*_mean_abs_percentage_error_update(preds, target))


def _symmetric_mape_update(preds: Tensor, target: Tensor, epsilon: float = _EPS) -> Tuple[Tensor, Tensor]:
    """(Σ2|ŷ-y| / max(|y| + |ŷ|, ε), n) (``mape.py:46``)."""
    preds, target = _as_float(preds, target)
    abs_per_error = torch.abs(preds - target) / torch.clamp(torch.abs(target) + torch.abs(preds), min=epsilon)
    return torch.sum(2 * abs_per_error), _num_obs(target.numel(), target)


def symmetric_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """SMAPE (``mape.py:56``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import symmetric_mean_absolute_percentage_error
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> print(f"{float(symmetric_mean_absolute_percentage_error(preds, target)):.4f}")
        0.2455
    """
    _check_same_shape(preds, target)
    s, n = _symmetric_mape_update(preds, target)
    return s / n


def _weighted_mape_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """(Σ|ŷ-y|, Σ|y|) (``mape.py:73``)."""
    preds, target = _as_float(preds, target)
    return torch.sum(torch.abs(preds - target)), torch.sum(torch.abs(target))


def _weighted_mape_compute(sum_abs_error: Tensor, sum_scale: Tensor, epsilon: float = _EPS) -> Tensor:
    return sum_abs_error / torch.clamp(sum_scale, min=epsilon)


def weighted_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """WMAPE (``mape.py:86``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import weighted_mean_absolute_percentage_error
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> print(f"{float(weighted_mean_absolute_percentage_error(preds, target)):.4f}")
        0.1600
    """
    _check_same_shape(preds, target)
    return _weighted_mape_compute(*_weighted_mape_update(preds, target))
