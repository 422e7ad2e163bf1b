"""R2Score and RelativeSquaredError (counterpart of ``torchmetrics_tpu/regression/r2.py``): the
moment sums Σy², Σy, Σ(y-ŷ)² and n, one compute group between the two.

``R2Score``'s compute reads nothing on the host. With fewer than two samples it returns what the
JAX module returns (0.0 for one sample) where the functional ``r2_score`` raises; an ``adjusted``
at or beyond ``n - 1`` gives the standard score, picked on the device: the JAX functional's value.
The JAX module's traced compute applies the correction there instead (ROADMAP queue C).
"""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.regression.r2 import (
    ALLOWED_MULTIOUTPUT,
    _check_adjusted,
    _check_r2_input,
    _r2_score_compute,
    _r2_score_update,
)
from torchmetrics_tpu_torch.functional.regression.rse import _relative_squared_error_compute
from torchmetrics_tpu_torch.regression.base import _ColumnStates


class _MomentSums(_ColumnStates):
    is_differentiable = True
    full_state_update = False
    _column_states = ("sum_squared_error", "sum_error", "residual")

    def _create_state(self, num_outputs: int) -> None:
        self.num_outputs = num_outputs
        shape = (num_outputs,) if num_outputs > 1 else ()
        for name in self._column_states:
            self.add_state(name, torch.zeros(shape, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _validate(self, preds, target) -> None:
        _check_r2_input(preds, target)
        self._widen_states(preds)

    def _update(self, state, preds, target):
        sum_squared_obs, sum_obs, rss, n = _r2_score_update(preds, target)
        if self.num_outputs == 1 and sum_obs.shape == (1,):
            sum_squared_obs, sum_obs, rss = sum_squared_obs[0], sum_obs[0], rss[0]
        return {
            "sum_squared_error": state["sum_squared_error"] + sum_squared_obs,
            "sum_error": state["sum_error"] + sum_obs,
            "residual": state["residual"] + rss,
            "total": state["total"] + n,
        }


class R2Score(_MomentSums):
    """R² (``r2.py:13``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import R2Score
        >>> metric = R2Score(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.9486
    """

    higher_is_better = True

    def __init__(self, num_outputs: int = 1, adjusted: int = 0, multioutput: str = "uniform_average",
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_adjusted(adjusted)
        if multioutput not in ALLOWED_MULTIOUTPUT:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {ALLOWED_MULTIOUTPUT}"
            )
        self.adjusted = adjusted
        self.multioutput = multioutput
        self._create_state(num_outputs)

    def _compute(self, state):
        return _r2_score_compute(state["sum_squared_error"], state["sum_error"], state["residual"], state["total"],
                                 self.adjusted, self.multioutput)


class RelativeSquaredError(_MomentSums):
    """RSE (``r2.py:76``)."""

    higher_is_better = False

    def __init__(self, num_outputs: int = 1, squared: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.squared = squared
        self._create_state(num_outputs)

    def _compute(self, state):
        return _relative_squared_error_compute(state["sum_squared_error"], state["sum_error"], state["residual"],
                                               state["total"], self.squared)
