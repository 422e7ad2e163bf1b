"""LogCosh error (counterpart of ``torchmetrics_tpu/functional/regression/log_cosh.py``)."""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.utils import _as_float, _check_data_shape_to_num_outputs, _num_obs


def _log_cosh_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """(Σ log cosh(ŷ-y) per output column, n) (``log_cosh.py:18``), as ``|x| + log1p(exp(-2|x|)) - log 2``."""
    preds, target = _as_float(preds, target)
    if preds.ndim == 1:
        preds, target = preds[:, None], target[:, None]
    a = torch.abs(preds - target)
    vals = a + torch.log1p(torch.exp(-2 * a)) - math.log(2.0)
    return torch.sum(vals, dim=0), _num_obs(preds.shape[0], preds)


def _log_cosh_error_compute(sum_log_cosh_error: Tensor, total: Tensor) -> Tensor:
    return torch.squeeze(sum_log_cosh_error / total)


def log_cosh_error(preds: Tensor, target: Tensor) -> Tensor:
    """LogCosh error (``log_cosh.py:32``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import log_cosh_error
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> print(f"{float(log_cosh_error(preds, target)):.4f}")
        0.1685
    """
    num_outputs = 1 if preds.ndim == 1 else preds.shape[1]
    _check_data_shape_to_num_outputs(preds, target, num_outputs)
    return _log_cosh_error_compute(*_log_cosh_error_update(preds, target))
