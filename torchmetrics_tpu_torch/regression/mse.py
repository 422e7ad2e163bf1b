"""MeanSquaredError, MeanAbsoluteError, MeanSquaredLogError (counterpart of
``torchmetrics_tpu/regression/mse.py``): float32 sum states."""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.regression.log_mse import _mean_squared_log_error_update
from torchmetrics_tpu_torch.functional.regression.mae import _mean_absolute_error_compute, _mean_absolute_error_update
from torchmetrics_tpu_torch.functional.regression.mse import _mean_squared_error_compute, _mean_squared_error_update
from torchmetrics_tpu_torch.regression.base import _check_num_outputs, _SameShape


class MeanSquaredError(_SameShape):
    """MSE, or RMSE with ``squared=False`` (``mse.py:20``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
        >>> metric = MeanSquaredError(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.3750
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, squared: bool = True, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(squared, bool):
            raise ValueError(f"Argument `squared` must be a boolean but got {squared}")
        _check_num_outputs(num_outputs)
        self.squared = squared
        self.num_outputs = num_outputs
        shape = (num_outputs,) if num_outputs > 1 else ()
        self.add_state("sum_squared_error", torch.zeros(shape, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _update(self, state, preds, target):
        sse, n = _mean_squared_error_update(preds, target, self.num_outputs)
        return {"sum_squared_error": state["sum_squared_error"] + sse, "total": state["total"] + n}

    def _compute(self, state):
        return _mean_squared_error_compute(state["sum_squared_error"], state["total"], self.squared)


class MeanAbsoluteError(_SameShape):
    """MAE (``mse.py:59``)."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_abs_error", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _update(self, state, preds, target):
        sae, n = _mean_absolute_error_update(preds, target)
        return {"sum_abs_error": state["sum_abs_error"] + sae, "total": state["total"] + n}

    def _compute(self, state):
        return _mean_absolute_error_compute(state["sum_abs_error"], state["total"])


class MeanSquaredLogError(_SameShape):
    """MSLE (``mse.py:91``)."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_squared_log_error", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _update(self, state, preds, target):
        s, n = _mean_squared_log_error_update(preds, target)
        return {"sum_squared_log_error": state["sum_squared_log_error"] + s, "total": state["total"] + n}

    def _compute(self, state):
        return state["sum_squared_log_error"] / state["total"]
