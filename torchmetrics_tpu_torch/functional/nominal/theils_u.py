"""Theil's U (counterpart of ``torchmetrics_tpu/functional/nominal/theils_u.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.nominal.utils import (
    _as_codes,
    _joint_relabel,
    _nominal_confmat_update,
    _nominal_input_validation,
    _pairwise_matrix,
)
from torchmetrics_tpu_torch.utils.compute import _flushed_floor


def _conditional_entropy_compute(confmat: Tensor) -> Tensor:
    """H(X|Y) of the table, rows the ``target`` categories Y (``theils_u.py:18``)."""
    confmat = confmat.to(torch.float32)
    total = _flushed_floor(confmat.sum())
    p_xy = confmat / total
    p_y = confmat.sum(dim=1) / total
    pos = p_xy > 0
    safe_xy = torch.where(pos, p_xy, 1.0)
    safe_y = _flushed_floor(p_y)[:, None]
    return torch.sum(torch.where(pos, p_xy * (torch.log(safe_y) - torch.log(safe_xy)), 0.0))


def _theils_u_update(
    preds: Tensor, target: Tensor, num_classes: int, nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """``theils_u.py:30``."""
    return _nominal_confmat_update(preds, target, num_classes, nan_strategy, nan_replace_value)


def _theils_u_compute(confmat: Tensor) -> Tensor:
    """``U = (H(X) - H(X|Y)) / H(X)`` with X the ``preds`` (columns) (``theils_u.py:37``)."""
    confmat = confmat.to(torch.float32)
    s_xy = _conditional_entropy_compute(confmat)
    p_x = confmat.sum(dim=0) / _flushed_floor(confmat.sum())
    pos = p_x > 0
    safe_x = torch.where(pos, p_x, 1.0)
    s_x = -torch.sum(torch.where(pos, safe_x * torch.log(safe_x), 0.0))
    return torch.where(s_x == 0, 0.0, (s_x - s_xy) / _flushed_floor(s_x))


def theils_u(
    preds: Tensor, target: Tensor, nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0
) -> Tensor:
    """Theil's U of ``preds`` given ``target``, asymmetric (``theils_u.py:49``)."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    p_idx, t_idx, num_classes = _joint_relabel(*_as_codes(preds, target), nan_strategy, nan_replace_value)
    return _theils_u_compute(_theils_u_update(p_idx, t_idx, num_classes))


def theils_u_matrix(
    matrix: Tensor, nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0
) -> Tensor:
    """Pairwise Theil's U over the columns, both orders (``theils_u.py:70``)."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _pairwise_matrix(matrix, lambda x, y: theils_u(x, y, nan_strategy, nan_replace_value), symmetric=False)
