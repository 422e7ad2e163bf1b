"""Sliding-window RMSE (counterpart of ``torchmetrics_tpu/functional/image/rmse_sw.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helpers import _uniform_filter
from torchmetrics_tpu_torch.utils.checks import _check_same_shape


def _rmse_sw_checks(preds: Tensor, target: Tensor, window_size: int) -> None:
    """``rmse_sw.py:13``."""
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. But got {tuple(preds.shape)}.")
    if round(window_size / 2) >= target.shape[2] or round(window_size / 2) >= target.shape[3]:
        raise ValueError(
            f"Parameter `round(window_size / 2)` is expected to be smaller than"
            f" {min(target.shape[2], target.shape[3])} but got {round(window_size / 2)}."
        )


def _rmse_sw_update(
    preds: Tensor,
    target: Tensor,
    window_size: int,
    rmse_val_sum: Optional[Tensor],
    rmse_map: Optional[Tensor],
    total_images: Optional[Tensor],
) -> Tuple[Optional[Tensor], Tensor, Tensor]:
    """Accumulate the per-window RMSE map of a batch (``rmse_sw.py:24``); the crop is
    ``round(window_size / 2)``, Python's banker's rounding, as in JAX."""
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    _rmse_sw_checks(preds, target, window_size)
    batch = float(target.shape[0])
    total_images = torch.full((), batch, dtype=torch.float32, device=target.device) if total_images is None else total_images + batch
    rmse_map_b = torch.sqrt(_uniform_filter(torch.square(target - preds), window_size))
    crop = round(window_size / 2)
    batch_val = torch.mean(torch.sum(rmse_map_b[:, :, crop:-crop, crop:-crop], dim=0))
    rmse_val_sum = batch_val if rmse_val_sum is None else rmse_val_sum + batch_val
    batch_map = torch.sum(rmse_map_b, dim=0)
    rmse_map = batch_map if rmse_map is None else rmse_map + batch_map
    return rmse_val_sum, rmse_map, total_images


def _rmse_sw_compute(
    rmse_val_sum: Optional[Tensor], rmse_map: Tensor, total_images: Tensor
) -> Tuple[Optional[Tensor], Tensor]:
    """``rmse_sw.py:63``."""
    rmse = rmse_val_sum / total_images if rmse_val_sum is not None else None
    return rmse, rmse_map / total_images


def root_mean_squared_error_using_sliding_window(
    preds: Tensor, target: Tensor, window_size: int = 8, return_rmse_map: bool = False
):
    """Sliding-window RMSE (``rmse_sw.py:71``)."""
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError("Argument `window_size` must be a positive integer.")
    rmse_val_sum, rmse_map, total_images = _rmse_sw_update(
        preds, target, window_size, rmse_val_sum=None, rmse_map=None, total_images=None
    )
    rmse, rmse_map = _rmse_sw_compute(rmse_val_sum, rmse_map, total_images)
    return (rmse, rmse_map) if return_rmse_map else rmse
