"""Minkowski distance (counterpart of ``torchmetrics_tpu/functional/regression/minkowski.py``)."""
from __future__ import annotations

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.utils import _as_float, _check_same_shape
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError


def _check_minkowski_p(p: float) -> None:
    if not (isinstance(p, (float, int)) and p >= 1):
        raise TorchMetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {p}")


def _minkowski_distance_update(preds: Tensor, target: Tensor, p: float) -> Tensor:
    """Σ|ŷ-y|^p (``minkowski.py:11``)."""
    _check_minkowski_p(p)
    preds, target = _as_float(preds, target)
    return torch.sum(torch.pow(torch.abs(preds - target), p))


def _minkowski_distance_compute(distance: Tensor, p: float) -> Tensor:
    return torch.pow(distance, 1.0 / p)


def minkowski_distance(preds: Tensor, targets: Tensor, p: float) -> Tensor:
    """Minkowski distance (``minkowski.py:23``; the second argument is ``targets``, as in the reference).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import minkowski_distance
        >>> preds, targets = torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.5, 2.5, 4.0])
        >>> print(f"{float(minkowski_distance(preds, targets, p=3)):.4f}")
        1.0772
    """
    _check_same_shape(preds, targets)
    return _minkowski_distance_compute(_minkowski_distance_update(preds, targets, p), p)
