"""Cramer's V (counterpart of ``torchmetrics_tpu/functional/nominal/cramers.py``)."""
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


def _cramers_v_update(
    preds: Tensor, target: Tensor, num_classes: int, nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """``cramers.py:23``."""
    return _nominal_confmat_update(preds, target, num_classes, nan_strategy, nan_replace_value)


def _cramers_v_compute(confmat: Tensor, bias_correction: bool) -> Tensor:
    """``cramers.py:30``, masked where the reference drops empty rows and columns. The warning that
    bias correction cannot be used reads the device, so a captured compute skips it; the eager
    compute (``Metric.compute``, the functional) gives it."""
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
            _unable_to_use_bias_correction_warning(metric_name="Cramer's V")
        value = torch.sqrt(phi_squared_corrected / _flushed_floor(min_corrected - 1))
        value = torch.where(min_corrected == 1.0, float("nan"), value)
    else:
        value = torch.sqrt(phi_squared / _flushed_floor(torch.minimum(num_rows - 1, num_cols - 1)))
    return torch.clamp(value, 0.0, 1.0)


def cramers_v(
    preds: Tensor,
    target: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Cramer's V between two categorical series (``cramers.py:52``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import cramers_v
        >>> preds = torch.tensor([0, 1, 1, 2, 2, 2])
        >>> target = torch.tensor([0, 1, 1, 2, 1, 2])
        >>> print(f"{float(cramers_v(preds, target)):.4f}")
        0.7328
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    p_idx, t_idx, num_classes = _joint_relabel(*_as_codes(preds, target), nan_strategy, nan_replace_value)
    return _cramers_v_compute(_cramers_v_update(p_idx, t_idx, num_classes), bias_correction)


def cramers_v_matrix(
    matrix: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Pairwise Cramer's V over the columns of an ``(N, V)`` categorical matrix (``cramers.py:77``),
    one pair at a time from the host."""
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _pairwise_matrix(matrix, lambda x, y: cramers_v(x, y, bias_correction, nan_strategy, nan_replace_value))
