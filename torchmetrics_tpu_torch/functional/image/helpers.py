"""Shared image-filter helpers (counterpart of ``torchmetrics_tpu/functional/image/helpers.py``).

Every filter is a depthwise convolution, ``F.conv2d``/``F.conv3d`` with ``groups`` the channel
count, as the JAX package's ``lax.conv_general_dilated`` with ``feature_group_count``
(``helpers.py:44-67``), run in full float32 whatever TF32 flags the caller set
(``utils/precision.full_float32``): cuDNN serves every single-channel convolution, and it runs
them in TF32 by default.

The windows are made on the input's device from ``torch.arange`` (``_gaussian_1d``, the uniform
window a ``torch.full``), and the pads are one ``index_select`` per padded axis with indices made
the same way, so a step that builds them copies nothing from the host and can be captured in a
CUDA graph. The pads follow numpy's ``reflect`` and ``symmetric`` modes, which reflect again where
the pad is not smaller than the axis, as ``jnp.pad`` does; ``F.pad(mode="reflect")`` would raise
there, and PyTorch has no ``symmetric`` mode.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F  # noqa: N812
from torch import Tensor

from torchmetrics_tpu_torch.utils.precision import full_float32


def _gaussian_1d(kernel_size: int, sigma: float, device: torch.device, dtype: torch.dtype = torch.float32) -> Tensor:
    """Normalised 1D gaussian window (``helpers.py:16``)."""
    dist = torch.arange(kernel_size, dtype=dtype, device=device) - (kernel_size - 1) / 2
    gauss = torch.exp(-torch.square(dist / sigma) / 2)
    return gauss / torch.sum(gauss)


def _gaussian_kernel_2d(channel: int, kernel_size: Sequence[int], sigma: Sequence[float], device: torch.device) -> Tensor:
    """The 2D gaussian as a depthwise weight ``(C, 1, kh, kw)`` (``helpers.py:23``)."""
    kernel = torch.outer(_gaussian_1d(kernel_size[0], sigma[0], device), _gaussian_1d(kernel_size[1], sigma[1], device))
    return kernel.expand(channel, 1, *kernel.shape)


def _gaussian_kernel_3d(channel: int, kernel_size: Sequence[int], sigma: Sequence[float], device: torch.device) -> Tensor:
    """The 3D gaussian as a depthwise weight ``(C, 1, k1, k2, k3)`` (``helpers.py:33``)."""
    kx, ky, kz = (_gaussian_1d(k, s, device) for k, s in zip(kernel_size, sigma))
    kernel = kx[:, None, None] * ky[None, :, None] * kz[None, None, :]
    return kernel.expand(channel, 1, *kernel.shape)


def _uniform_kernel(channel: int, kernel_size: Sequence[int], value: float, device: torch.device) -> Tensor:
    return torch.full((channel, 1, *kernel_size), value, dtype=torch.float32, device=device)


def _depthwise_conv(x: Tensor, kernel: Tensor, stride: int = 1) -> Tensor:
    """Valid-mode depthwise convolution over the trailing 2 or 3 axes of ``(N, C, ...)``."""
    conv = F.conv3d if x.ndim == 5 else F.conv2d
    with full_float32():
        return conv(x, kernel.contiguous(), stride=stride, groups=x.shape[1])


def _pad_index(n: int, before: int, after: int, symmetric: bool, device: torch.device) -> Tensor:
    """Source indices of numpy's ``reflect`` (edge excluded) or ``symmetric`` (edge included) pad of
    an axis of ``n``, for any pad size."""
    idx = torch.arange(-before, n + after, device=device)
    if symmetric:
        period = 2 * n
        idx = torch.remainder(idx, period)
        return torch.where(idx >= n, period - 1 - idx, idx)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def _pad(x: Tensor, pads: Sequence[Sequence[int]], symmetric: bool) -> Tensor:
    """``x`` padded on its trailing ``len(pads)`` axes by ``(before, after)`` each."""
    first = x.ndim - len(pads)
    for axis, (before, after) in enumerate(pads, start=first):
        if before or after:
            x = x.index_select(axis, _pad_index(x.shape[axis], before, after, symmetric, x.device))
    return x


def _reflect_pad(x: Tensor, *pads: int) -> Tensor:
    """Edge-excluding reflection of the trailing axes, ``pads[i]`` on both sides of each
    (``helpers.py:70``, ``:75``)."""
    return _pad(x, [(p, p) for p in pads], symmetric=False)


def _symmetric_pad_2d(x: Tensor, pad: int, outer_pad: int) -> Tensor:
    """Edge-including reflection, ``pad`` on the left and ``pad + outer_pad - 1`` on the right of each
    spatial axis (``helpers.py:81``: scipy's ``uniform_filter`` alignment for even windows)."""
    right = pad + outer_pad - 1
    return _pad(x, [(pad, right), (pad, right)], symmetric=True)


def _uniform_filter(x: Tensor, window_size: int) -> Tensor:
    """Sliding-window mean, as scipy's ``uniform_filter`` (``helpers.py:92``)."""
    x = _symmetric_pad_2d(x, window_size // 2, window_size % 2)
    return _depthwise_conv(x, _uniform_kernel(x.shape[1], (window_size, window_size), 1.0 / window_size**2, x.device))


def _avg_pool(x: Tensor, spatial_dims: int) -> Tensor:
    """2x downsample by mean, floor semantics (``helpers.py:100``)."""
    return F.avg_pool3d(x, 2) if spatial_dims == 3 else F.avg_pool2d(x, 2)


def reduce(x: Tensor, reduction: str = "elementwise_mean") -> Tensor:
    """elementwise_mean, sum or none (``helpers.py:107``)."""
    if reduction == "elementwise_mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    if reduction is None or reduction == "none":
        return x
    raise ValueError("Expected reduction to be one of `elementwise_mean`, `sum`, `none`, None")
