"""Universal image quality index (counterpart of ``torchmetrics_tpu/functional/image/uqi.py``):
the five filtered moments of SSIM from one depthwise convolution of a ``(5·B, C, H, W)`` stack."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helpers import _depthwise_conv, _gaussian_kernel_2d, _reflect_pad, reduce
from torchmetrics_tpu_torch.utils.checks import _check_same_shape

_EPS = float(torch.finfo(torch.float32).eps)


def _uqi_check_inputs(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """``uqi.py:21``."""
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _five_moments(preds: Tensor, target: Tensor, kernel: Tensor):
    """``(mu_p, mu_t, E[p²], E[t²], E[pt])`` from one convolution of the stacked planes."""
    stacked = torch.cat((preds, target, preds * preds, target * target, preds * target), dim=0)
    return torch.chunk(_depthwise_conv(stacked, kernel), 5, dim=0)


def _uqi_map(
    preds: Tensor, target: Tensor, kernel_size: Sequence[int] = (11, 11), sigma: Sequence[float] = (1.5, 1.5)
) -> Tensor:
    """The cropped per-pixel UQI map (``uqi.py:34``)."""
    kernel = _gaussian_kernel_2d(preds.shape[1], kernel_size, sigma, preds.device)
    pad_h, pad_w = (kernel_size[0] - 1) // 2, (kernel_size[1] - 1) // 2
    mu_p, mu_t, e_pp, e_tt, e_pt = _five_moments(_reflect_pad(preds, pad_h, pad_w), _reflect_pad(target, pad_h, pad_w),
                                                 kernel)
    mu_pred_sq, mu_target_sq, mu_pred_target = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    upper = 2 * (e_pt - mu_pred_target)
    lower = (e_pp - mu_pred_sq) + (e_tt - mu_target_sq)
    uqi_idx = ((2 * mu_pred_target) * upper) / ((mu_pred_sq + mu_target_sq) * lower + _EPS)
    return uqi_idx[..., pad_h:-pad_h, pad_w:-pad_w]


def _uqi_compute(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """``uqi.py:65``."""
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"`kernel_size` must have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"`sigma` must have positive number. Got {sigma}.")
    return reduce(_uqi_map(preds, target, kernel_size, sigma), reduction)


def universal_image_quality_index(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """UQI (``uqi.py:84``)."""
    preds, target = _uqi_check_inputs(preds, target)
    return _uqi_compute(preds, target, kernel_size, sigma, reduction)
