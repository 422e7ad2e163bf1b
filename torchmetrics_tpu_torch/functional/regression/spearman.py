"""Spearman rank correlation (counterpart of ``torchmetrics_tpu/functional/regression/spearman.py``).

Average ranks of tied values without a read of the device: one stable sort per column, tie groups
from a cumsum of "new value" flags, each group's size an integer scatter-add (no float atomics, so
both dispatch tiers and reruns give the same bits), and the group's average rank
``first + (size + 1) / 2``, exact in float32 below 2^24 samples. As in the JAX package, a NaN is a
group of its own (``NaN != NaN``), sorted last, and ``-0.0`` ties ``+0.0``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs


def _tie_groups(data: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """For ``(N,)`` or ``(N, d)`` data, along dim 0: the sorting permutation, each sorted element's
    group id, and each group's size (int64, zero-padded to N) and first sorted position."""
    sorted_data, order = torch.sort(data, dim=0, stable=True)
    is_new = torch.ones_like(sorted_data, dtype=torch.int64)
    is_new[1:] = (sorted_data[1:] != sorted_data[:-1]).to(torch.int64)
    group_id = torch.cumsum(is_new, dim=0) - 1
    sizes = torch.zeros_like(group_id).scatter_add_(0, group_id, torch.ones_like(group_id))
    first = torch.cumsum(sizes, dim=0) - sizes
    return order, group_id, sizes, first


def _rank_data(data: Tensor) -> Tensor:
    """Average-tie ranks (1-based), along dim 0 of ``(N,)`` or ``(N, d)`` data (``spearman.py:14``)."""
    order, group_id, sizes, first = _tie_groups(data)
    ranks_sorted = (2 * torch.gather(first, 0, group_id) + torch.gather(sizes, 0, group_id) + 1).to(torch.float32) / 2
    return torch.empty_like(ranks_sorted).scatter_(0, order, ranks_sorted)


def _spearman_corrcoef_compute(preds: Tensor, target: Tensor, eps: float = 1.17e-06) -> Tensor:
    """Pearson over the ranks (``spearman.py:33``); the columns of 2-D inputs ranked in one sort."""
    rp, rt = _rank_data(preds), _rank_data(target)
    pd = rp - torch.mean(rp, dim=0)
    td = rt - torch.mean(rt, dim=0)
    cov = torch.mean(pd * td, dim=0)
    corr = cov / torch.clamp(torch.sqrt(torch.mean(pd * pd, dim=0) * torch.mean(td * td, dim=0)), min=eps)
    return torch.squeeze(torch.clamp(corr, -1.0, 1.0))


def spearman_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Spearman rank correlation (``spearman.py:48``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import spearman_corrcoef
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> print(f"{float(spearman_corrcoef(preds, target)):.4f}")
        1.0000
    """
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    _check_data_shape_to_num_outputs(preds, target, 1 if preds.ndim == 1 else preds.shape[1])
    return _spearman_corrcoef_compute(preds, target)
