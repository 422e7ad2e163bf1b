"""Mean squared error (counterpart of ``torchmetrics_tpu/functional/regression/mse.py``)."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.utils import _as_float, _check_same_shape, _num_obs


def _mean_squared_error_update(preds: Tensor, target: Tensor, num_outputs: int) -> Tuple[Tensor, Tensor]:
    """(Σ(ŷ-y)² per output, n) (``mse.py:12``); one output flattens the inputs."""
    if num_outputs == 1:
        preds, target = preds.reshape(-1), target.reshape(-1)
    preds, target = _as_float(preds, target)
    diff = preds - target
    return torch.sum(diff * diff, dim=0), _num_obs(target.shape[0], target)


def _mean_squared_error_compute(sum_squared_error: Tensor, total: Tensor, squared: bool = True) -> Tensor:
    mse = sum_squared_error / total
    return mse if squared else torch.sqrt(mse)


def mean_squared_error(preds: Tensor, target: Tensor, squared: bool = True, num_outputs: int = 1) -> Tensor:
    """MSE, or RMSE with ``squared=False`` (``mse.py:29``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import mean_squared_error
        >>> round(float(mean_squared_error(torch.tensor([0.0, 1.0, 2.0]), torch.tensor([0.5, 1.0, 1.5]))), 6)
        0.166667
    """
    _check_same_shape(preds, target)
    sum_squared_error, total = _mean_squared_error_update(preds, target, num_outputs)
    return _mean_squared_error_compute(sum_squared_error, total, squared)
