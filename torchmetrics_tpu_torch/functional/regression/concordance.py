"""Concordance correlation coefficient (counterpart of
``torchmetrics_tpu/functional/regression/concordance.py``): CCC = 2·cov / (σx² + σy² + (μx - μy)²)
from the Pearson running state, with unbiased (n - 1) moments."""
from __future__ import annotations

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.pearson import _pearson_corrcoef_update, _zero_state
from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs


def _concordance_corrcoef_compute(mean_x: Tensor, mean_y: Tensor, var_x: Tensor, var_y: Tensor, corr_xy: Tensor,
                                  nb: Tensor) -> Tensor:
    """``concordance.py:14``."""
    vx = var_x / (nb - 1)
    vy = var_y / (nb - 1)
    cxy = corr_xy / (nb - 1)
    return torch.squeeze(2.0 * cxy / (vx + vy + (mean_x - mean_y) ** 2))


def concordance_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Concordance correlation coefficient (``concordance.py:25``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import concordance_corrcoef
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> print(f"{float(concordance_corrcoef(preds, target)):.4f}")
        0.9729
    """
    d, zero = _zero_state(preds)
    _check_data_shape_to_num_outputs(preds, target, d)
    return _concordance_corrcoef_compute(*_pearson_corrcoef_update(preds, target, *zero, num_outputs=d))
