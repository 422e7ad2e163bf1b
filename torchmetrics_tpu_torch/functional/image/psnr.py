"""Peak signal-to-noise ratio (counterpart of ``torchmetrics_tpu/functional/image/psnr.py``).

Counts are float32 device tensors made with ``torch.full`` (no copy from the host, so a captured
step can make them), as the JAX package's ``jnp.asarray(target.size, jnp.float32)`` (``psnr.py:22``).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helpers import reduce
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn


def _full(n: float, like: Tensor, shape=()) -> Tensor:
    return torch.full(shape, float(n), dtype=torch.float32, device=like.device)


def _psnr_update(preds: Tensor, target: Tensor, dim: Optional[Union[int, Tuple[int, ...]]] = None) -> Tuple[Tensor, Tensor]:
    """Sum of squared errors and the observation count, over all or per ``dim`` (``psnr.py:14``)."""
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    diff = preds - target
    if dim is None:
        return torch.sum(diff * diff), _full(target.numel(), target)
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    if not dim_list:
        # ``jnp.sum(axis=())`` sums over nothing
        return diff * diff, _full(target.numel(), target)
    sum_squared_error = torch.sum(diff * diff, dim=dim_list)
    n = 1
    for d in dim_list:
        n *= target.shape[d]
    return sum_squared_error, _full(n, target, sum_squared_error.shape)


def _log_base_factor(base: float) -> float:
    """``10 / ln(base)`` in float32, as the JAX package computes it."""
    return float(np.float32(10) / np.log(np.float32(base)))


def _psnr_compute(
    sum_squared_error: Tensor, num_obs: Tensor, data_range: Tensor, base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """``psnr.py:40``."""
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / num_obs)
    return reduce(psnr_base_e * _log_base_factor(base), reduction)


def peak_signal_noise_ratio(
    preds: Tensor,
    target: Tensor,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tensor:
    """PSNR (``psnr.py:53``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import peak_signal_noise_ratio
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> print(f"{float(peak_signal_noise_ratio(preds, target, data_range=3.0)):.2f}")
        2.55
    """
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = torch.max(target) - torch.min(target)
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range = _full(np.float32(data_range[1] - data_range[0]), target)
    else:
        data_range = _full(float(data_range), target)
    sum_squared_error, num_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, num_obs, data_range, base=base, reduction=reduction)
