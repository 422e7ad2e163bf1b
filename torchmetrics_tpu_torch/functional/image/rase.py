"""Relative average spectral error (counterpart of ``torchmetrics_tpu/functional/image/rase.py``)."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helpers import _uniform_filter
from torchmetrics_tpu_torch.functional.image.rmse_sw import _rmse_sw_compute, _rmse_sw_update


def _rase_update(
    preds: Tensor, target: Tensor, window_size: int, rmse_map: Tensor, target_sum: Tensor, total_images: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """``rase.py:12``: the local target mean is divided by ``window_size**2`` once more, as in JAX
    and the reference (``rase.py:45`` there)."""
    _, rmse_map, total_images = _rmse_sw_update(
        preds, target, window_size, rmse_val_sum=None, rmse_map=rmse_map, total_images=total_images
    )
    target = target.to(torch.float32)
    target_sum = target_sum + torch.sum(_uniform_filter(target, window_size) / window_size**2, dim=0)
    return rmse_map, target_sum, total_images


def _rase_compute(rmse_map: Tensor, target_sum: Tensor, total_images: Tensor, window_size: int) -> Tensor:
    """``rase.py:36``."""
    _, rmse_map = _rmse_sw_compute(rmse_val_sum=None, rmse_map=rmse_map, total_images=total_images)
    target_mean = torch.mean(target_sum / total_images, dim=0)  # mean over channels
    rase_map = 100 / target_mean * torch.sqrt(torch.mean(torch.square(rmse_map), dim=0))
    crop = round(window_size / 2)
    return torch.mean(rase_map[crop:-crop, crop:-crop])


def relative_average_spectral_error(preds: Tensor, target: Tensor, window_size: int = 8) -> Tensor:
    """RASE (``rase.py:48``)."""
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError("Argument `window_size` must be a positive integer.")
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    img_shape = target.shape[1:]
    rmse_map = torch.zeros(img_shape, dtype=torch.float32, device=target.device)
    target_sum = torch.zeros(img_shape, dtype=torch.float32, device=target.device)
    total_images = torch.zeros((), dtype=torch.float32, device=target.device)
    rmse_map, target_sum, total_images = _rase_update(preds, target, window_size, rmse_map, target_sum, total_images)
    return _rase_compute(rmse_map, target_sum, total_images, window_size)
