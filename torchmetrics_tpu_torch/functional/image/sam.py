"""Spectral angle mapper (counterpart of ``torchmetrics_tpu/functional/image/sam.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helpers import reduce
from torchmetrics_tpu_torch.utils.checks import _check_same_shape


def _sam_check_inputs(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """``sam.py:13``."""
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    if preds.shape[1] <= 1:
        raise ValueError(
            "Expected channel dimension of `preds` and `target` to be larger than 1."
            f" Got preds: {preds.shape[1]} and target: {target.shape[1]}."
        )
    return preds, target


def _sam_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """Per-pixel spectral angle over the channel axis (``sam.py:31``)."""
    dot_product = torch.sum(preds * target, dim=1)
    preds_norm = torch.linalg.vector_norm(preds, dim=1)
    target_norm = torch.linalg.vector_norm(target, dim=1)
    sam_score = torch.arccos(torch.clamp(dot_product / (preds_norm * target_norm), -1, 1))
    return reduce(sam_score, reduction)


def spectral_angle_mapper(preds: Tensor, target: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """SAM (``sam.py:42``)."""
    preds, target = _sam_check_inputs(preds, target)
    return _sam_compute(preds, target, reduction)
