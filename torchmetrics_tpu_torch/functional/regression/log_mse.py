"""Mean squared log error (counterpart of ``torchmetrics_tpu/functional/regression/log_mse.py``)."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.utils import _as_float, _check_same_shape, _num_obs


def _mean_squared_log_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """(Σ(log1p ŷ - log1p y)², n) (``log_mse.py:12``)."""
    preds, target = _as_float(preds, target)
    d = torch.log1p(preds) - torch.log1p(target)
    return torch.sum(d * d), _num_obs(preds.numel(), preds)


def mean_squared_log_error(preds: Tensor, target: Tensor) -> Tensor:
    """MSLE (``log_mse.py:20``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mean_squared_log_error
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> print(f"{float(mean_squared_log_error(preds, target)):.4f}")
        0.0286
    """
    _check_same_shape(preds, target)
    s, n = _mean_squared_log_error_update(preds, target)
    return s / n
