"""SSIM and MS-SSIM (counterpart of ``torchmetrics_tpu/functional/image/ssim.py``).

The five filtered moments come from one depthwise convolution of a ``(5·B, C, ...)`` stack, as in
JAX. The padding always comes from the gaussian's support ``int(3.5σ + 0.5)·2 + 1``, even for the
uniform kernel (``ssim.py:91-95``). MS-SSIM's ``data_range=None`` is recomputed from the pooled
images at each scale, and its weights ``cs ** beta`` are taken scale by scale with Python
exponents, so no tensor of betas is copied from the host.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helpers import (
    _avg_pool,
    _gaussian_kernel_2d,
    _gaussian_kernel_3d,
    _reflect_pad,
    _uniform_kernel,
    reduce,
)
from torchmetrics_tpu_torch.functional.image.uqi import _five_moments
from torchmetrics_tpu_torch.utils.checks import _check_same_shape


def _ssim_check_inputs(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """``ssim.py:28``."""
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    _check_same_shape(preds, target)
    if preds.ndim not in (4, 5):
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW or BxCxDxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _ssim_validate_args(kernel_size: Sequence[int], sigma: Sequence[float], ndim: int) -> None:
    if len(kernel_size) != ndim - 2:
        raise ValueError(
            f"`kernel_size` has dimension {len(kernel_size)}, but expected to be two less that target dimensionality,"
            f" which is: {ndim}"
        )
    if len(kernel_size) not in (2, 3):
        raise ValueError(
            f"`kernel_size` dimension must be 2 or 3. `kernel_size` dimensionality: {len(kernel_size)}"
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"`kernel_size` must have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"`sigma` must have positive number. Got {sigma}.")


def _as_list(value, n: int) -> list:
    return list(value) if isinstance(value, Sequence) else n * [value]


def _ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """Per-image SSIM (``ssim.py:57``)."""
    is_3d = preds.ndim == 5
    kernel_size, sigma = _as_list(kernel_size, 3 if is_3d else 2), _as_list(sigma, 3 if is_3d else 2)
    _ssim_validate_args(kernel_size, sigma, preds.ndim)
    if return_full_image and return_contrast_sensitivity:
        raise ValueError("Arguments `return_full_image` and `return_contrast_sensitivity` are mutually exclusive.")

    if data_range is None:
        data_range = torch.maximum(torch.max(preds) - torch.min(preds), torch.max(target) - torch.min(target))
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range = data_range[1] - data_range[0]
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    channel = preds.shape[1]
    gauss_kernel_size = [int(3.5 * s + 0.5) * 2 + 1 for s in sigma]
    pads = [(k - 1) // 2 for k in gauss_kernel_size]
    preds, target = _reflect_pad(preds, *pads), _reflect_pad(target, *pads)
    if gaussian_kernel:
        make = _gaussian_kernel_3d if is_3d else _gaussian_kernel_2d
        kernel = make(channel, gauss_kernel_size, sigma, preds.device)
    else:
        kernel = _uniform_kernel(channel, kernel_size, float(np.float32(1.0) / np.float32(np.prod(kernel_size))),
                                 preds.device)

    mu_p, mu_t, e_pp, e_tt, e_pt = _five_moments(preds, target, kernel)
    mu_pred_sq, mu_target_sq, mu_pred_target = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    upper = 2 * (e_pt - mu_pred_target) + c2
    lower = (e_pp - mu_pred_sq) + (e_tt - mu_target_sq) + c2
    ssim_full = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)

    def crop(im: Tensor) -> Tensor:  # ``pad:-pad`` as in JAX: a pad of 0 crops to nothing
        return im[(Ellipsis, *(slice(pad, -pad) for pad in pads))]

    batch = ssim_full.shape[0]
    per_image = torch.mean(crop(ssim_full).reshape(batch, -1), dim=-1)
    if return_contrast_sensitivity:
        return per_image, torch.mean(crop(upper / lower).reshape(batch, -1), dim=-1)
    if return_full_image:
        return per_image, ssim_full
    return per_image


def structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
):
    """SSIM (``ssim.py:150``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import structural_similarity_index_measure
        >>> x = torch.rand(1, 1, 16, 16, generator=torch.Generator().manual_seed(0))
        >>> print(f"{float(structural_similarity_index_measure(x, x, data_range=1.0)):.4f}")
        1.0000
    """
    preds, target = _ssim_check_inputs(preds, target)
    pack = _ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
        return_full_image, return_contrast_sensitivity,
    )
    if isinstance(pack, tuple):
        similarity, image = pack
        return reduce(similarity, reduction), image
    return reduce(pack, reduction)


def _multiscale_ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> Tensor:
    """Per-image MS-SSIM over the unrolled scale pyramid (``ssim.py:188``)."""
    is_3d = preds.ndim == 5
    kernel_size, sigma = _as_list(kernel_size, 3 if is_3d else 2), _as_list(sigma, 3 if is_3d else 2)
    if preds.shape[-1] < 2 ** len(betas) or preds.shape[-2] < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width dimensions must be"
            f" larger than or equal to {2 ** len(betas)}."
        )
    betas_div = max(1, (len(betas) - 1)) ** 2
    if preds.shape[-2] // betas_div <= kernel_size[0] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[0]},"
            f" the image height must be larger than {(kernel_size[0] - 1) * betas_div}."
        )
    if preds.shape[-1] // betas_div <= kernel_size[1] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[1]},"
            f" the image width must be larger than {(kernel_size[1] - 1) * betas_div}."
        )

    mcs_list = []
    sim = None
    for scale in range(len(betas)):
        sim, cs = _ssim_update(preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2,
                               return_contrast_sensitivity=True)
        if normalize == "relu":
            sim, cs = torch.clamp_min(sim, 0.0), torch.clamp_min(cs, 0.0)
        mcs_list.append(cs)
        if scale != len(betas) - 1:
            preds, target = _avg_pool(preds, 3 if is_3d else 2), _avg_pool(target, 3 if is_3d else 2)
    mcs_list[-1] = sim
    if normalize == "simple":
        mcs_list = [(m + 1) / 2 for m in mcs_list]
    weighted = torch.stack([m ** float(np.float32(beta)) for m, beta in zip(mcs_list, betas)])
    return torch.prod(weighted, dim=0)


def multiscale_structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = "relu",
) -> Tensor:
    """MS-SSIM (``ssim.py:238``)."""
    if not isinstance(betas, tuple):
        raise ValueError("Argument `betas` is expected to be of a type tuple.")
    if not all(isinstance(beta, float) for beta in betas):
        raise ValueError("Argument `betas` is expected to be a tuple of floats.")
    if normalize and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
    preds, target = _ssim_check_inputs(preds, target)
    mcs = _multiscale_ssim_update(preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, betas, normalize)
    return reduce(mcs, reduction)
