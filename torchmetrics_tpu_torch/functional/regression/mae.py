"""Mean absolute error (counterpart of ``torchmetrics_tpu/functional/regression/mae.py``)."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.utils import _as_float, _check_same_shape, _num_obs


def _mean_absolute_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """(Σ|ŷ-y|, n) over every element (``mae.py:12``)."""
    preds, target = _as_float(preds, target)
    return torch.sum(torch.abs(preds - target)), _num_obs(preds.numel(), preds)


def _mean_absolute_error_compute(sum_abs_error: Tensor, total: Tensor) -> Tensor:
    return sum_abs_error / total


def mean_absolute_error(preds: Tensor, target: Tensor) -> Tensor:
    """MAE (``mae.py:24``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mean_absolute_error
        >>> preds, target = torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> print(f"{float(mean_absolute_error(preds, target)):.4f}")
        0.5000
    """
    _check_same_shape(preds, target)
    return _mean_absolute_error_compute(*_mean_absolute_error_update(preds, target))
