"""Pearson's contingency coefficient (counterpart of ``torchmetrics_tpu/functional/nominal/pearson.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.nominal.utils import (
    _as_codes,
    _compute_chi_squared,
    _joint_relabel,
    _nominal_confmat_update,
    _nominal_input_validation,
    _pairwise_matrix,
)
from torchmetrics_tpu_torch.utils.compute import _flushed_floor


def _pearsons_contingency_coefficient_update(
    preds: Tensor, target: Tensor, num_classes: int, nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """``pearson.py:19``."""
    return _nominal_confmat_update(preds, target, num_classes, nan_strategy, nan_replace_value)


def _pearsons_contingency_coefficient_compute(confmat: Tensor) -> Tensor:
    """``pearson.py:26``."""
    confmat = confmat.to(torch.float32)
    phi_squared = _compute_chi_squared(confmat, bias_correction=False) / _flushed_floor(confmat.sum())
    return torch.clamp(torch.sqrt(phi_squared / (1 + phi_squared)), 0.0, 1.0)


def pearsons_contingency_coefficient(
    preds: Tensor, target: Tensor, nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0
) -> Tensor:
    """Pearson's contingency coefficient (``pearson.py:35``)."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    p_idx, t_idx, num_classes = _joint_relabel(*_as_codes(preds, target), nan_strategy, nan_replace_value)
    return _pearsons_contingency_coefficient_compute(_pearsons_contingency_coefficient_update(p_idx, t_idx, num_classes))


def pearsons_contingency_coefficient_matrix(
    matrix: Tensor, nan_strategy: str = "replace", nan_replace_value: Optional[float] = 0.0
) -> Tensor:
    """Pairwise coefficient over the columns (``pearson.py:56``)."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _pairwise_matrix(matrix, lambda x, y: pearsons_contingency_coefficient(x, y, nan_strategy, nan_replace_value))
