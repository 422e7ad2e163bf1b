"""Shared nominal-association steps (counterpart of ``torchmetrics_tpu/functional/nominal/utils.py``).

The contingency table is a ``(C, C)`` confusion matrix, rows ``target`` and columns ``preds``,
counted by K1 (``ops/histogram.confusion_matrix_update``) and held as float32, as in the JAX
package. NaN "drop" is a bool mask that K1 applies in registers: no read of the device, so the
update can be captured in a CUDA graph. Empty rows and columns stay in place and are masked
(``utils.py:69-107``), where the reference drops them with a dynamic gather.
"""
from __future__ import annotations

import itertools
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops import histogram
from torchmetrics_tpu_torch.utils.compute import _flushed_floor
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn


def _nominal_input_validation(nan_strategy: str, nan_replace_value: Optional[float]) -> None:
    """``utils.py:21``."""
    if nan_strategy not in ("replace", "drop"):
        raise ValueError(
            f"Argument `nan_strategy` is expected to be one of `['replace', 'drop']`, but got {nan_strategy}"
        )
    if nan_strategy == "replace" and not isinstance(nan_replace_value, (float, int)):
        raise ValueError(
            "Argument `nan_replace` is expected to be of a type `int` or `float` when `nan_strategy = 'replace`, "
            f"but got {nan_replace_value}"
        )


def _nominal_confmat_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """float32 ``(C, C)`` counts of a batch (``utils.py:34``): argmax when 2-D, NaN replaced or
    dropped, codes truncated to int32, then one K1 launch. A code outside ``[0, C)``, a replaced
    NaN included, is dropped, as the JAX package's one-hot drops it."""
    preds, target = _as_codes(preds, target)
    preds_f = preds.to(torch.float32)
    target_f = target.to(torch.float32)
    mask = None
    if nan_strategy == "replace":
        preds_f = torch.where(torch.isnan(preds_f), nan_replace_value, preds_f)
        target_f = torch.where(torch.isnan(target_f), nan_replace_value, target_f)
    else:
        nan_mask = torch.isnan(preds_f) | torch.isnan(target_f)
        preds_f = torch.where(nan_mask, 0.0, preds_f)
        target_f = torch.where(nan_mask, 0.0, target_f)
        mask = ~nan_mask
    return histogram.confusion_matrix_update(
        preds_f.to(torch.int32), target_f.to(torch.int32), num_classes, weights=mask
    ).to(torch.float32)


def _effective_shape(confmat: Tensor) -> Tuple[Tensor, Tensor]:
    """Non-empty (rows, cols) counts as float32 device scalars (``utils.py:74``)."""
    return (confmat.sum(dim=1) > 0).sum().to(torch.float32), (confmat.sum(dim=0) > 0).sum().to(torch.float32)


def _expected_freqs(confmat: Tensor) -> Tensor:
    """Outer-product expected frequencies (``utils.py:80``); zero for empty cells."""
    rows = confmat.sum(dim=1)
    cols = confmat.sum(dim=0)
    return rows[:, None] * cols[None, :] / _flushed_floor(confmat.sum())


def _compute_chi_squared(confmat: Tensor, bias_correction: bool) -> Tensor:
    """Chi-squared over the non-empty cells (``utils.py:87``); with ``bias_correction`` the Yates
    correction is chosen on the device where ``df == 1``."""
    expected = _expected_freqs(confmat)
    valid = expected > 0
    n_rows, n_cols = _effective_shape(confmat)
    df = n_rows * n_cols - n_rows - n_cols + 1.0
    safe_e = torch.where(valid, expected, 1.0)
    chi = torch.sum(torch.where(valid, (confmat - expected) ** 2 / safe_e, 0.0))
    if bias_correction:
        diff = expected - confmat
        corrected = confmat + torch.sign(diff) * torch.clamp_max(torch.abs(diff), 0.5)
        chi_corr = torch.sum(torch.where(valid, (corrected - expected) ** 2 / safe_e, 0.0))
        chi = torch.where(df == 1.0, chi_corr, chi)
    return torch.where(df == 0.0, 0.0, chi)


def _compute_phi_squared_corrected(phi_squared: Tensor, num_rows: Tensor, num_cols: Tensor, confmat_sum: Tensor) -> Tensor:
    """``utils.py:110``."""
    return torch.clamp_min(phi_squared - ((num_rows - 1) * (num_cols - 1)) / _flushed_floor(confmat_sum - 1), 0.0)


def _compute_rows_and_cols_corrected(num_rows: Tensor, num_cols: Tensor, confmat_sum: Tensor) -> Tuple[Tensor, Tensor]:
    """``utils.py:115``."""
    denom = _flushed_floor(confmat_sum - 1)
    return num_rows - (num_rows - 1) ** 2 / denom, num_cols - (num_cols - 1) ** 2 / denom


def _compute_bias_corrected_values(
    phi_squared: Tensor, num_rows: Tensor, num_cols: Tensor, confmat_sum: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """``utils.py:121``."""
    return (
        _compute_phi_squared_corrected(phi_squared, num_rows, num_cols, confmat_sum),
        *_compute_rows_and_cols_corrected(num_rows, num_cols, confmat_sum),
    )


def _unable_to_use_bias_correction_warning(metric_name: str) -> None:
    rank_zero_warn(
        f"Unable to compute {metric_name} using bias correction. Consider setting `bias_correction=False`."
    )


def _joint_relabel(
    preds: Tensor, target: Tensor, nan_strategy: str, nan_replace_value: Optional[float]
) -> Tuple[Tensor, Tensor, int]:
    """Dense ``0..C-1`` codes of both series under one joint ``np.unique`` on the host, and ``C``
    (``utils.py:137``, kept a host step as in the JAX package): gapped or arbitrary category values
    give the statistic of their dense codes."""
    p = preds.detach().cpu().numpy().astype(np.float32).reshape(-1)
    t = target.detach().cpu().numpy().astype(np.float32).reshape(-1)
    if nan_strategy == "replace":
        p = np.nan_to_num(p, nan=nan_replace_value)
        t = np.nan_to_num(t, nan=nan_replace_value)
    else:
        keep = ~(np.isnan(p) | np.isnan(t))
        p, t = p[keep], t[keep]
    uniq, inv = np.unique(np.concatenate([p, t]), return_inverse=True)
    codes = torch.from_numpy(inv.reshape(-1).astype(np.int32)).to(preds.device)
    return codes[: len(p)], codes[len(p):], max(len(uniq), 1)


def _as_codes(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Each 2-D series as the argmax over its dim 1 (``utils.py:45-48``, ``cramers.py:69-70``)."""
    preds = torch.argmax(preds, dim=1) if preds.dim() == 2 else preds
    target = torch.argmax(target, dim=1) if target.dim() == 2 else target
    return preds, target


def _pairwise_matrix(matrix: Tensor, statistic: Callable[[Tensor, Tensor], Tensor], symmetric: bool = True) -> Tensor:
    """float32 ``(V, V)`` matrix of ``statistic(column i, column j)`` over the columns of an
    ``(N, V)`` categorical matrix, 1 on the diagonal, one pair at a time from the host as in the JAX
    package (``cramers.py:77``); a symmetric statistic is computed once per pair."""
    num_variables = matrix.shape[1]
    out = torch.ones((num_variables, num_variables), dtype=torch.float32)
    pairs = itertools.combinations if symmetric else itertools.permutations
    for i, j in pairs(range(num_variables), 2):
        out[i, j] = float(statistic(matrix[:, i], matrix[:, j]))
        if symmetric:
            out[j, i] = out[i, j]
    return out.to(matrix.device)
