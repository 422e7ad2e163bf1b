"""The SNR family (counterpart of ``torchmetrics_tpu/functional/audio/snr.py``).

Each entry reduces over the trailing time axis in float32, as the JAX package does, with the same
``eps`` in numerator and denominator. Elementwise products and sums only: nothing reads the device
from the host, so the classes' updates capture as CUDA graphs.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.utils.checks import _check_same_shape

_EPS = float(np.finfo(np.float32).eps)


def _as_float(x) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _zero_mean(x: Tensor, dims=-1) -> Tensor:
    return x - torch.mean(x, dim=dims, keepdim=True)


def signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SNR in dB per sample over the trailing time axis (JAX ``snr.py:12``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import signal_noise_ratio
        >>> round(float(signal_noise_ratio(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))), 2)
        16.18
    """
    preds, target = _as_float(preds), _as_float(target)
    _check_same_shape(preds, target)
    if zero_mean:
        target, preds = _zero_mean(target), _zero_mean(preds)
    noise = target - preds
    snr_value = (torch.sum(torch.square(target), dim=-1) + _EPS) / (torch.sum(torch.square(noise), dim=-1) + _EPS)
    return 10 * torch.log10(snr_value)


def scale_invariant_signal_distortion_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SI-SDR in dB per sample (JAX ``snr.py:31``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_distortion_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> print(f"{float(scale_invariant_signal_distortion_ratio(preds, target)):.4f}")
        18.4030
    """
    preds, target = _as_float(preds), _as_float(target)
    _check_same_shape(preds, target)
    if zero_mean:
        target, preds = _zero_mean(target), _zero_mean(preds)
    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + _EPS) / (
        torch.sum(torch.square(target), dim=-1, keepdim=True) + _EPS
    )
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = (torch.sum(torch.square(target_scaled), dim=-1) + _EPS) / (torch.sum(torch.square(noise), dim=-1) + _EPS)
    return 10 * torch.log10(val)


def scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor) -> Tensor:
    """SI-SNR: SI-SDR of zero-mean inputs (JAX ``snr.py:57``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_noise_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> print(f"{float(scale_invariant_signal_noise_ratio(preds, target)):.4f}")
        15.0918
    """
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=True)


def complex_scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """C-SI-SNR over complex ``(..., freq, time)`` or real-view ``(..., freq, time, 2)`` spectrograms
    (JAX ``snr.py:71``)."""
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    if torch.is_complex(preds):
        preds = torch.view_as_real(preds)
    if torch.is_complex(target):
        target = torch.view_as_real(target)
    if (preds.ndim < 3 or preds.shape[-1] != 2) or (target.ndim < 3 or target.shape[-1] != 2):
        raise RuntimeError(
            "Predictions and targets are expected to have the shape (..., frequency, time, 2),"
            f" but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )
    preds = preds.reshape(*preds.shape[:-3], -1)
    target = target.reshape(*target.shape[:-3], -1)
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=zero_mean)


def source_aggregated_signal_distortion_ratio(
    preds: Tensor, target: Tensor, scale_invariant: bool = True, zero_mean: bool = False
) -> Tensor:
    """SA-SDR over ``(..., spk, time)`` (JAX ``snr.py:91``)."""
    preds, target = _as_float(preds), _as_float(target)
    _check_same_shape(preds, target)
    if preds.ndim < 2:
        raise RuntimeError(f"The preds and target should have the shape (..., spk, time), but {tuple(preds.shape)} found")
    if zero_mean:
        target, preds = _zero_mean(target), _zero_mean(preds)
    if scale_invariant:
        alpha = (torch.sum(preds * target, dim=(-2, -1), keepdim=True) + _EPS) / (
            torch.sum(torch.square(target), dim=(-2, -1), keepdim=True) + _EPS
        )
        target = alpha * target
    distortion = target - preds
    val = (torch.sum(torch.square(target), dim=(-2, -1)) + _EPS) / (torch.sum(torch.square(distortion), dim=(-2, -1)) + _EPS)
    return 10 * torch.log10(val)
