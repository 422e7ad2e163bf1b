"""MeanAbsolutePercentageError, SymmetricMeanAbsolutePercentageError,
WeightedMeanAbsolutePercentageError (counterpart of ``torchmetrics_tpu/regression/mape.py``)."""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.regression.mape import (
    _mean_abs_percentage_error_compute,
    _mean_abs_percentage_error_update,
    _symmetric_mape_update,
    _weighted_mape_compute,
    _weighted_mape_update,
)
from torchmetrics_tpu_torch.regression.base import _SameShape


class MeanAbsolutePercentageError(_SameShape):
    """MAPE (``mape.py:19``)."""
    plot_lower_bound = 0.0

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _update(self, state, preds, target):
        s, n = _mean_abs_percentage_error_update(preds, target)
        return {"sum_abs_per_error": state["sum_abs_per_error"] + s, "total": state["total"] + n}

    def _compute(self, state):
        return _mean_abs_percentage_error_compute(state["sum_abs_per_error"], state["total"])


class SymmetricMeanAbsolutePercentageError(_SameShape):
    """SMAPE (``mape.py:51``)."""
    plot_lower_bound = 0.0
    plot_upper_bound = 2.0

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_per_error", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _update(self, state, preds, target):
        s, n = _symmetric_mape_update(preds, target)
        return {"sum_abs_per_error": state["sum_abs_per_error"] + s, "total": state["total"] + n}

    def _compute(self, state):
        return state["sum_abs_per_error"] / state["total"]


class WeightedMeanAbsolutePercentageError(_SameShape):
    """WMAPE (``mape.py:84``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import WeightedMeanAbsolutePercentageError
        >>> metric = WeightedMeanAbsolutePercentageError(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.1600
    """
    plot_lower_bound = 0.0

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("sum_scale", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _update(self, state, preds, target):
        s, scale = _weighted_mape_update(preds, target)
        return {"sum_abs_error": state["sum_abs_error"] + s, "sum_scale": state["sum_scale"] + scale}

    def _compute(self, state):
        return _weighted_mape_compute(state["sum_abs_error"], state["sum_scale"])
