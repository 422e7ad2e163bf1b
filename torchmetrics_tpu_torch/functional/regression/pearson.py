"""Pearson correlation (counterpart of ``torchmetrics_tpu/functional/regression/pearson.py``).

The state is a running mean, variance and covariance sum with a count (Welford-style). The update
keeps the JAX package's branch-free first batch (``pearson.py:19-48``): with zero means, the
incremental cross-terms equal the first batch's own sums. ``_final_aggregation`` merges replica
states stacked along a leading world axis (Chan et al.'s parallel update), as sync will hand them.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.utils import _as_float, _check_data_shape_to_num_outputs

_State = Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]


def _pearson_corrcoef_update(preds: Tensor, target: Tensor, mean_x: Tensor, mean_y: Tensor, var_x: Tensor,
                             var_y: Tensor, corr_xy: Tensor, num_prior: Tensor, num_outputs: int) -> _State:
    """One batch folded into the running state (``pearson.py:19``)."""
    preds, target = _as_float(preds, target)
    if num_outputs == 1:
        preds, target = preds.reshape(-1), target.reshape(-1)
    total = num_prior + float(preds.shape[0])
    mx_new = (num_prior * mean_x + preds.sum(dim=0)) / total
    my_new = (num_prior * mean_y + target.sum(dim=0)) / total
    # the cross-terms use the old running mean (reference pearson.py:104-110)
    var_x = var_x + torch.sum((preds - mx_new) * (preds - mean_x), dim=0)
    var_y = var_y + torch.sum((target - my_new) * (target - mean_y), dim=0)
    corr_xy = corr_xy + torch.sum((preds - mx_new) * (target - mean_y), dim=0)
    return mx_new, my_new, var_x, var_y, corr_xy, total


def _pearson_corrcoef_compute(var_x: Tensor, var_y: Tensor, corr_xy: Tensor, nb: Tensor) -> Tensor:
    """cov / (σx σy), clipped to [-1, 1] (``pearson.py:51``)."""
    var_x = var_x / (nb - 1)
    var_y = var_y / (nb - 1)
    corr_xy = corr_xy / (nb - 1)
    return torch.squeeze(torch.clamp(corr_xy / torch.sqrt(var_x * var_y), -1.0, 1.0))


def _merge(a: _State, b: _State) -> _State:
    """Two replica states as one (``pearson.py:75-116``)."""
    mx1, my1, vx1, vy1, cxy1, n1 = a
    mx2, my2, vx2, vy2, cxy2, n2 = b
    nb = n1 + n2
    safe_nb = torch.where(nb == 0, 1.0, nb)
    mean_x = (n1 * mx1 + n2 * mx2) / safe_nb
    mean_y = (n1 * my1 + n2 * my2) / safe_nb
    element_x1 = (n1 + 1) * mean_x - n1 * mx1
    vx = vx1 + (element_x1 - mx1) * (element_x1 - mean_x) - (element_x1 - mean_x) ** 2
    element_x2 = (n2 + 1) * mean_x - n2 * mx2
    vx = vx + vx2 + (element_x2 - mx2) * (element_x2 - mean_x) - (element_x2 - mean_x) ** 2
    element_y1 = (n1 + 1) * mean_y - n1 * my1
    vy = vy1 + (element_y1 - my1) * (element_y1 - mean_y) - (element_y1 - mean_y) ** 2
    element_y2 = (n2 + 1) * mean_y - n2 * my2
    vy = vy + vy2 + (element_y2 - my2) * (element_y2 - mean_y) - (element_y2 - mean_y) ** 2
    cxy = cxy1 + (element_x1 - mx1) * (element_y1 - mean_y) - (element_x1 - mean_x) * (element_y1 - mean_y)
    cxy = cxy + cxy2 + (element_x2 - mx2) * (element_y2 - mean_y) - (element_x2 - mean_x) * (element_y2 - mean_y)
    return mean_x, mean_y, vx, vy, cxy, nb


def _final_aggregation(means_x: Tensor, means_y: Tensor, vars_x: Tensor, vars_y: Tensor, corrs_xy: Tensor,
                       nbs: Tensor) -> _State:
    """Fold replica states along a leading world axis, in order (``pearson.py:62``)."""
    state = (means_x[0], means_y[0], vars_x[0], vars_y[0], corrs_xy[0], nbs[0])
    for i in range(1, means_x.shape[0]):
        state = _merge(state, (means_x[i], means_y[i], vars_x[i], vars_y[i], corrs_xy[i], nbs[i]))
    return state


def _zero_state(preds: Tensor) -> Tuple[int, _State]:
    """``num_outputs`` of ``preds`` and the zero state of that width."""
    d = preds.shape[1] if preds.ndim == 2 else 1
    zeros = torch.zeros((d,) if d > 1 else (), dtype=torch.float32, device=preds.device)
    return d, (zeros, zeros, zeros, zeros, zeros, torch.zeros((), dtype=torch.float32, device=preds.device))


def pearson_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Pearson correlation coefficient (``pearson.py:124``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pearson_corrcoef
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> print(f"{float(pearson_corrcoef(preds, target)):.4f}")
        0.9838
    """
    d, zero = _zero_state(preds)
    _check_data_shape_to_num_outputs(preds, target, d)
    _, _, var_x, var_y, corr_xy, nb = _pearson_corrcoef_update(preds, target, *zero, num_outputs=d)
    return _pearson_corrcoef_compute(var_x, var_y, corr_xy, nb)
