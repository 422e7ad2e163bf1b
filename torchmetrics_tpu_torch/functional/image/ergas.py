"""ERGAS (counterpart of ``torchmetrics_tpu/functional/image/ergas.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helpers import reduce
from torchmetrics_tpu_torch.utils.checks import _check_same_shape


def _ergas_check_inputs(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """``ergas.py:13``."""
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _ergas_compute(preds: Tensor, target: Tensor, ratio: float = 4, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """Per-image ERGAS over per-band RMSE (``ergas.py:27``)."""
    b, c, h, w = preds.shape
    preds, target = preds.reshape(b, c, h * w), target.reshape(b, c, h * w)
    diff = preds - target
    rmse_per_band = torch.sqrt(torch.sum(diff * diff, dim=2) / (h * w))
    mean_target = torch.mean(target, dim=2)
    ergas_score = 100 * ratio * torch.sqrt(torch.sum(torch.square(rmse_per_band / mean_target), dim=1) / c)
    return reduce(ergas_score, reduction)


def error_relative_global_dimensionless_synthesis(
    preds: Tensor, target: Tensor, ratio: float = 4, reduction: Optional[str] = "elementwise_mean"
) -> Tensor:
    """ERGAS (``ergas.py:44``)."""
    preds, target = _ergas_check_inputs(preds, target)
    return _ergas_compute(preds, target, ratio, reduction)
