"""Tschuprow's T (counterpart of ``torchmetrics_tpu/functional/nominal/tschuprows.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.nominal.utils import (
    _as_codes,
    _compute_bias_corrected_values,
    _compute_chi_squared,
    _effective_shape,
    _joint_relabel,
    _nominal_confmat_update,
    _nominal_input_validation,
    _pairwise_matrix,
    _unable_to_use_bias_correction_warning,
)
from torchmetrics_tpu_torch.utils import checks
from torchmetrics_tpu_torch.utils.compute import _flushed_floor


def _tschuprows_t_update(
    preds: Tensor, target: Tensor, num_classes: int, nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """``tschuprows.py:23``."""
    return _nominal_confmat_update(preds, target, num_classes, nan_strategy, nan_replace_value)


def _tschuprows_t_compute(confmat: Tensor, bias_correction: bool) -> Tensor:
    """``tschuprows.py:30``; its warning is skipped under capture, as Cramer's V's."""
    confmat = confmat.to(torch.float32)
    cm_sum = confmat.sum()
    chi_squared = _compute_chi_squared(confmat, bias_correction)
    phi_squared = chi_squared / _flushed_floor(cm_sum)
    num_rows, num_cols = _effective_shape(confmat)
    if bias_correction:
        phi_squared_corrected, rows_corrected, cols_corrected = _compute_bias_corrected_values(
            phi_squared, num_rows, num_cols, cm_sum
        )
        min_corrected = torch.minimum(rows_corrected, cols_corrected)
        if not checks.capturing(min_corrected) and float(min_corrected) == 1.0:
            _unable_to_use_bias_correction_warning(metric_name="Tschuprow's T")
        denom = torch.sqrt(_flushed_floor((rows_corrected - 1) * (cols_corrected - 1)))
        value = torch.sqrt(phi_squared_corrected / denom)
        value = torch.where(min_corrected == 1.0, float("nan"), value)
    else:
        denom = torch.sqrt(_flushed_floor((num_rows - 1) * (num_cols - 1)))
        value = torch.sqrt(phi_squared / denom)
    return torch.clamp(value, 0.0, 1.0)


def tschuprows_t(
    preds: Tensor,
    target: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Tschuprow's T (``tschuprows.py:54``)."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    p_idx, t_idx, num_classes = _joint_relabel(*_as_codes(preds, target), nan_strategy, nan_replace_value)
    return _tschuprows_t_compute(_tschuprows_t_update(p_idx, t_idx, num_classes), bias_correction)


def tschuprows_t_matrix(
    matrix: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Pairwise Tschuprow's T over the columns (``tschuprows.py:79``)."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _pairwise_matrix(matrix, lambda x, y: tschuprows_t(x, y, bias_correction, nan_strategy, nan_replace_value))
