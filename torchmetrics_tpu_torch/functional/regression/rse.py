"""Relative squared error (counterpart of ``torchmetrics_tpu/functional/regression/rse.py``).

RSE = Σ(y-ŷ)² / Σ(y-ȳ)², the denominator rebuilt from R²'s moment sums, in float32.
"""
from __future__ import annotations

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.r2 import _check_r2_input, _r2_score_update

_F32_EPS = float(torch.finfo(torch.float32).eps)


def _relative_squared_error_compute(sum_squared_obs: Tensor, sum_obs: Tensor, rss: Tensor, num_obs: Tensor,
                                    squared: bool = True) -> Tensor:
    """``rse.py:14``."""
    tss = sum_squared_obs - sum_obs * sum_obs / num_obs
    rse = rss / torch.clamp(tss, min=_F32_EPS)
    if not squared:
        rse = torch.sqrt(rse)
    return torch.mean(rse)


def relative_squared_error(preds: Tensor, target: Tensor, squared: bool = True) -> Tensor:
    """Relative squared error (``rse.py:30``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import relative_squared_error
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> print(f"{float(relative_squared_error(preds, target)):.4f}")
        0.0647
    """
    _check_r2_input(preds, target)
    return _relative_squared_error_compute(*_r2_score_update(preds, target), squared)
