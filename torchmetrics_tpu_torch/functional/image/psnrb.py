"""PSNR with the blocking effect factor (counterpart of ``torchmetrics_tpu/functional/image/psnrb.py``).

The JAX package gathers the columns and rows on and off the block boundaries with index sets built
in numpy from the shape (``psnrb.py:24-31``). The port squares every neighbour difference once
and splits the sum with a boundary mask made on the device (``arange % block_size``): the same
terms, no copy from the host, so the step can be captured.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.psnr import _full


def _split_sum(sq: Tensor, axis: int, block_size: int) -> Tuple[Tensor, Tensor]:
    """Sums of ``sq`` at the block boundaries of ``axis`` (positions ``block_size - 1 + k·block_size``)
    and off them."""
    on = torch.remainder(torch.arange(sq.shape[axis], device=sq.device), block_size) == block_size - 1
    on = on.reshape([-1 if a == axis % sq.ndim else 1 for a in range(sq.ndim)])
    return torch.sum(torch.where(on, sq, 0.0)), torch.sum(torch.where(on, 0.0, sq))


def _compute_bef(x: Tensor, block_size: int = 8) -> Tensor:
    """Blocking effect factor (``psnrb.py:17``)."""
    _, channels, height, width = x.shape
    if channels > 1:
        raise ValueError(f"`psnrb` metric expects grayscale images, but got images with {channels} channels.")
    h_b, h_bc = _split_sum(torch.square(x[:, :, :, :-1] - x[:, :, :, 1:]), 3, block_size)
    v_b, v_bc = _split_sum(torch.square(x[:, :, :-1, :] - x[:, :, 1:, :]), 2, block_size)
    d_b, d_bc = h_b + v_b, h_bc + v_bc

    n_hb = height * (width / block_size) - 1
    n_hbc = (height * (width - 1)) - n_hb
    n_vb = width * (height / block_size) - 1
    n_vbc = (width * (height - 1)) - n_vb
    d_b = d_b / (n_hb + n_vb)
    d_bc = d_bc / (n_hbc + n_vbc)
    t_on = math.log2(block_size) / math.log2(min(height, width))
    t = torch.where(d_b > d_bc, t_on, 0.0)
    return t * (d_b - d_bc)


def _psnrb_update(preds: Tensor, target: Tensor, block_size: int = 8) -> Tuple[Tensor, Tensor, Tensor]:
    """``psnrb.py:47``."""
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    diff = preds - target
    return torch.sum(diff * diff), _compute_bef(preds, block_size=block_size), _full(target.numel(), target)


def _psnrb_compute(sum_squared_error: Tensor, bef: Tensor, num_obs: Tensor, data_range: Tensor) -> Tensor:
    """``psnrb.py:58``."""
    mse_b = sum_squared_error / num_obs + bef
    return torch.where(
        data_range > 2, 10 * torch.log10(torch.square(data_range) / mse_b), 10 * torch.log10(1.0 / mse_b)
    )


def peak_signal_noise_ratio_with_blocked_effect(preds: Tensor, target: Tensor, block_size: int = 8) -> Tensor:
    """PSNR-B (``psnrb.py:70``)."""
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    data_range = torch.max(target) - torch.min(target)
    sum_squared_error, bef, num_obs = _psnrb_update(preds, target, block_size=block_size)
    return _psnrb_compute(sum_squared_error, bef, num_obs, data_range)
