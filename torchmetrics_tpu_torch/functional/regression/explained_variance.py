"""Explained variance (counterpart of ``torchmetrics_tpu/functional/regression/explained_variance.py``).

State: the first and second moments of the target and of the error, per output column, float32.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.utils import _as_float, _check_same_shape, _num_obs

ALLOWED_MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


def _check_multioutput(multioutput: str) -> None:
    if multioutput not in ALLOWED_MULTIOUTPUT:
        raise ValueError(f"Invalid input to argument `multioutput`. Choose one of {ALLOWED_MULTIOUTPUT}")


def _explained_variance_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """(n, Σerr, Σerr², Σy, Σy²) per output column (``explained_variance.py:18``)."""
    preds, target = _as_float(preds, target)
    if preds.ndim == 1:
        preds, target = preds[:, None], target[:, None]
    diff = target - preds
    return (_num_obs(preds.shape[0], preds), torch.sum(diff, dim=0), torch.sum(diff * diff, dim=0),
            torch.sum(target, dim=0), torch.sum(target * target, dim=0))


def _explained_variance_compute(n_obs: Tensor, sum_error: Tensor, sum_squared_error: Tensor, sum_target: Tensor,
                                sum_squared_target: Tensor, multioutput: str = "uniform_average") -> Tensor:
    """``explained_variance.py:37``."""
    diff_avg = sum_error / n_obs
    numerator = sum_squared_error / n_obs - diff_avg * diff_avg
    target_avg = sum_target / n_obs
    denominator = sum_squared_target / n_obs - target_avg * target_avg
    nonzero_numerator = numerator != 0
    valid = nonzero_numerator & (denominator != 0)
    output_scores = torch.where(valid, 1.0 - numerator / torch.where(valid, denominator, 1.0),
                                torch.where(nonzero_numerator, 0.0, 1.0))
    if output_scores.shape == (1,):
        output_scores = torch.squeeze(output_scores)
    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    denom_sum = torch.sum(denominator)
    return torch.sum(torch.atleast_1d(output_scores) * denominator) / torch.where(denom_sum == 0, 1.0, denom_sum)


def explained_variance(preds: Tensor, target: Tensor, multioutput: str = "uniform_average") -> Tensor:
    """Explained variance (``explained_variance.py:66``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import explained_variance
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> print(f"{float(explained_variance(preds, target)):.4f}")
        0.9461
    """
    _check_multioutput(multioutput)
    _check_same_shape(preds, target)
    return _explained_variance_compute(*_explained_variance_update(preds, target), multioutput)
