"""Pixel-domain visual information fidelity (counterpart of ``torchmetrics_tpu/functional/image/vif.py``):
the channels folded into the batch, ``(C·N, 1, H, W)``, one convolution per filtered moment and
scale, four scales. Each scale's downsampling filter is a convolution of stride 2, the
``[::2, ::2]`` of the JAX package's full one (``vif.py:30``)."""
from __future__ import annotations

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helpers import _depthwise_conv


def _vif_filter(win_size: int, sigma: float, device: torch.device) -> Tensor:
    """Normalised 2D gaussian ``(1, 1, k, k)`` (``vif.py:15``)."""
    coords = torch.arange(win_size, dtype=torch.float32, device=device) - (win_size - 1) / 2
    g = torch.square(coords)
    g = torch.exp(-(g[None, :] + g[:, None]) / (2.0 * sigma**2))
    return (g / torch.sum(g))[None, None]


def _vif_per_image_channel(preds: Tensor, target: Tensor, sigma_n_sq: float) -> Tensor:
    """The VIF ratio of each ``(image, channel)`` plane of ``(M, 1, H, W)`` inputs (``vif.py:24``)."""
    eps = 1e-10
    preds_vif = torch.zeros(preds.shape[0], dtype=torch.float32, device=preds.device)
    target_vif = torch.zeros(preds.shape[0], dtype=torch.float32, device=preds.device)
    for scale in range(4):
        n = int(2.0 ** (4 - scale) + 1)
        kernel = _vif_filter(n, n / 5, preds.device)
        if scale > 0:
            target = _depthwise_conv(target, kernel, stride=2)
            preds = _depthwise_conv(preds, kernel, stride=2)

        mu_target = _depthwise_conv(target, kernel)
        mu_preds = _depthwise_conv(preds, kernel)
        mu_target_sq = torch.square(mu_target)
        mu_preds_sq = torch.square(mu_preds)
        mu_target_preds = mu_target * mu_preds

        sigma_target_sq = torch.clamp_min(_depthwise_conv(torch.square(target), kernel) - mu_target_sq, 0.0)
        sigma_preds_sq = torch.clamp_min(_depthwise_conv(torch.square(preds), kernel) - mu_preds_sq, 0.0)
        sigma_target_preds = _depthwise_conv(target * preds, kernel) - mu_target_preds

        g = sigma_target_preds / (sigma_target_sq + eps)
        sigma_v_sq = sigma_preds_sq - g * sigma_target_preds

        mask = sigma_target_sq < eps
        g = torch.where(mask, 0.0, g)
        sigma_v_sq = torch.where(mask, sigma_preds_sq, sigma_v_sq)
        sigma_target_sq = torch.where(mask, 0.0, sigma_target_sq)

        mask = sigma_preds_sq < eps
        g = torch.where(mask, 0.0, g)
        sigma_v_sq = torch.where(mask, 0.0, sigma_v_sq)

        mask = g < 0
        sigma_v_sq = torch.where(mask, sigma_preds_sq, sigma_v_sq)
        g = torch.where(mask, 0.0, g)
        sigma_v_sq = torch.clamp_min(sigma_v_sq, eps)

        preds_vif_scale = torch.log10(1.0 + torch.square(g) * sigma_target_sq / (sigma_v_sq + sigma_n_sq))
        preds_vif = preds_vif + torch.sum(preds_vif_scale, dim=(1, 2, 3))
        target_vif = target_vif + torch.sum(torch.log10(1.0 + sigma_target_sq / sigma_n_sq), dim=(1, 2, 3))
    return preds_vif / target_vif


def _channels_to_batch(x: Tensor) -> Tensor:
    """``(N, C, H, W)`` as ``(C·N, 1, H, W)``, channel-major, as the JAX package orders them."""
    n, c, h, w = x.shape
    return x.transpose(0, 1).reshape(c * n, 1, h, w)


def visual_information_fidelity(preds: Tensor, target: Tensor, sigma_n_sq: float = 2.0) -> Tensor:
    """VIF-p (``vif.py:67``)."""
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    if preds.shape[-1] < 41 or preds.shape[-2] < 41:
        raise ValueError(
            f"Invalid size of preds. Expected at least 41x41, but got {preds.shape[-1]}x{preds.shape[-2]}!"
        )
    if target.shape[-1] < 41 or target.shape[-2] < 41:
        raise ValueError(
            f"Invalid size of target. Expected at least 41x41, but got {target.shape[-1]}x{target.shape[-2]}!"
        )
    return torch.mean(_vif_per_image_channel(_channels_to_batch(preds), _channels_to_batch(target), sigma_n_sq))
