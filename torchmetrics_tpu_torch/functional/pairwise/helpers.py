"""Shared input handling of the pairwise distances (counterpart of
``torchmetrics_tpu/functional/pairwise/helpers.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor


def _check_input(x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None) -> Tuple[Tensor, Tensor, bool]:
    """Check the shapes and resolve the ``zero_diagonal`` default (``helpers.py:11``): ``x`` is
    ``[N, d]``, ``y`` is ``[M, d]`` or None (``x`` against itself, its diagonal zeroed by default)."""
    x = torch.as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"Expected argument `x` to be a 2D tensor of shape `[N, d]` but got {tuple(x.shape)}")
    if y is not None:
        y = torch.as_tensor(y, device=x.device)
        if y.ndim != 2 or y.shape[1] != x.shape[1]:
            raise ValueError(
                "Expected argument `y` to be a 2D tensor of shape `[M, d]` where"
                " `d` should be same as the last dimension of `x`"
            )
        zero_diagonal = False if zero_diagonal is None else zero_diagonal
    else:
        y = x
        zero_diagonal = True if zero_diagonal is None else zero_diagonal
    return x, y, zero_diagonal


def _zero_diagonal(distance: Tensor, zero_diagonal: bool) -> Tensor:
    """The matrix with its leading diagonal set to 0, also when it is not square (``helpers.py:35``).
    ``distance`` is a fresh tensor of the caller's, so it is written in place."""
    return distance.fill_diagonal_(0) if zero_diagonal else distance


def _reduce_distance_matrix(distmat: Tensor, reduction: Optional[str] = None) -> Tensor:
    """mean, sum or none over the last axis (``helpers.py:44``). The mean of integer distances is
    float32 and their sum keeps their dtype, as ``jnp.mean`` and ``jnp.sum`` give them."""
    if reduction == "mean":
        return torch.mean(distmat if distmat.is_floating_point() else distmat.to(torch.float32), dim=-1)
    if reduction == "sum":
        return torch.sum(distmat, dim=-1, dtype=distmat.dtype)
    if reduction is None or reduction == "none":
        return distmat
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', None]` but got {reduction}")
