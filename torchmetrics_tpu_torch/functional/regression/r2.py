"""R² score (counterpart of ``torchmetrics_tpu/functional/regression/r2.py``).

The state is four float32 moment sums per output column, and ``tss = Σy² - Σy·Σy/n`` is formed in
float32 as in the JAX package (``r2.py:26-30,44-45``): on targets with a large mean this cancels.

``_r2_score_compute`` reads nothing back to the host, so a captured compute may hold it. The JAX
package's compute checks ``n >= 2`` and warns on ``adjusted >= n - 1`` only when it is not traced;
here the functional ``r2_score`` makes those checks, and the module does not. Both pick the
standard score on the device where ``adjusted >= n - 1``, the value the JAX functional and the
reference return.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.utils import _as_float, _check_same_shape, _num_obs
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

ALLOWED_MULTIOUTPUT = ("raw_values", "uniform_average", "variance_weighted")


def _check_r2_input(preds: Tensor, target: Tensor) -> None:
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            "Expected both prediction and target to be 1D or 2D tensors, but received tensors with"
            f" dimension {tuple(preds.shape)}"
        )


def _check_adjusted(adjusted: int) -> None:
    if adjusted < 0 or not isinstance(adjusted, int):
        raise ValueError("`adjusted` parameter must be an integer larger or equal to 0.")


def _r2_score_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(Σy², Σy, Σ(y-ŷ)², n) per output column (``r2.py:13``)."""
    preds, target = _as_float(preds, target)
    if preds.ndim == 1:
        preds, target = preds[:, None], target[:, None]
    diff = target - preds
    return (torch.sum(target * target, dim=0), torch.sum(target, dim=0), torch.sum(diff * diff, dim=0),
            _num_obs(target.shape[0], target))


def _r2_score_compute(sum_squared_obs: Tensor, sum_obs: Tensor, rss: Tensor, num_obs: Tensor, adjusted: int = 0,
                      multioutput: str = "uniform_average") -> Tensor:
    """tss from the moments, the ``multioutput`` reduction and the ``adjusted`` correction (``r2.py:33``)."""
    mean_obs = sum_obs / num_obs
    tss = sum_squared_obs - sum_obs * mean_obs
    cond = tss != 0
    raw_scores = torch.where(cond, 1 - rss / torch.where(cond, tss, 1.0), 0.0)
    if multioutput == "raw_values":
        r2 = raw_scores
    elif multioutput == "uniform_average":
        r2 = torch.mean(raw_scores)
    elif multioutput == "variance_weighted":
        tss_sum = torch.sum(tss)
        r2 = torch.sum(tss / torch.where(tss_sum == 0, 1.0, tss_sum) * raw_scores)
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`,"
            f" `uniform_average` or `variance_weighted`. Received {multioutput}."
        )
    _check_adjusted(adjusted)
    if adjusted == 0:
        return r2
    adjusted_r2 = 1 - (1 - r2) * (num_obs - 1) / (num_obs - adjusted - 1)
    return torch.where(adjusted >= num_obs - 1, r2, adjusted_r2)


def r2_score(preds: Tensor, target: Tensor, adjusted: int = 0, multioutput: str = "uniform_average") -> Tensor:
    """R² score (``r2.py:76``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import r2_score
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> print(f"{float(r2_score(preds, target)):.4f}")
        0.9353
    """
    _check_r2_input(preds, target)
    sum_squared_obs, sum_obs, rss, num_obs = _r2_score_update(preds, target)
    n = float(num_obs)  # the JAX package's eager checks (``r2.py:41-42,61-72``)
    if n < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")
    value = _r2_score_compute(sum_squared_obs, sum_obs, rss, num_obs, adjusted, multioutput)
    if adjusted > n - 1:
        rank_zero_warn(
            "More independent regressions than data points in adjusted r2 score. Falls back to standard r2 score.",
            UserWarning,
        )
    elif adjusted != 0 and adjusted == n - 1:
        rank_zero_warn("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
    return value
