"""ExplainedVariance (counterpart of ``torchmetrics_tpu/regression/explained_variance.py``): the
error's and the target's first and second moments, float32, scalar until a multi-output batch
widens them (``regression/base.py``)."""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.regression.explained_variance import (
    _check_multioutput,
    _explained_variance_compute,
    _explained_variance_update,
)
from torchmetrics_tpu_torch.regression.base import _ColumnStates
from torchmetrics_tpu_torch.utils.checks import _check_same_shape


class ExplainedVariance(_ColumnStates):
    """Explained variance (``explained_variance.py:16``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import ExplainedVariance
        >>> metric = ExplainedVariance(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.9572
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    _column_states = ("sum_error", "sum_squared_error", "sum_target", "sum_squared_target")

    def __init__(self, multioutput: str = "uniform_average", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_multioutput(multioutput)
        self.multioutput = multioutput
        self.add_state("num_obs", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        for name in self._column_states:
            self.add_state(name, torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _validate(self, preds, target) -> None:
        _check_same_shape(preds, target)
        self._widen_states(preds)

    def _update(self, state, preds, target):
        n, se, sse, st, sst = _explained_variance_update(preds, target)
        if state["sum_error"].ndim == 0 and se.shape == (1,):
            se, sse, st, sst = se[0], sse[0], st[0], sst[0]
        return {
            "num_obs": state["num_obs"] + n,
            "sum_error": state["sum_error"] + se,
            "sum_squared_error": state["sum_squared_error"] + sse,
            "sum_target": state["sum_target"] + st,
            "sum_squared_target": state["sum_squared_target"] + sst,
        }

    def _compute(self, state):
        return _explained_variance_compute(state["num_obs"], state["sum_error"], state["sum_squared_error"],
                                           state["sum_target"], state["sum_squared_target"], self.multioutput)
