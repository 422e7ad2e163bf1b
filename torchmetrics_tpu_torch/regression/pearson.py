"""PearsonCorrCoef (counterpart of ``torchmetrics_tpu/regression/pearson.py``).

Six running states with ``dist_reduce_fx=None``: sync (not ported yet, ROADMAP queue A item 6)
stacks the replicas' states along a leading world axis, and ``_merged_state`` folds that axis with
``_final_aggregation`` before the compute. ``full_state_update``: a forward's batch value is
``compute(update(defaults, batch))``.
"""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.functional.regression.pearson import (
    _final_aggregation,
    _pearson_corrcoef_compute,
    _pearson_corrcoef_update,
)
from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.regression.base import _check_num_outputs

_STATES = ("mean_x", "mean_y", "var_x", "var_y", "corr_xy", "n_total")


class PearsonCorrCoef(Metric):
    """Pearson correlation coefficient (``pearson.py:20``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import PearsonCorrCoef
        >>> metric = PearsonCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.9849
    """

    is_differentiable = True
    higher_is_better = None
    full_state_update = True

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_num_outputs(num_outputs, "an int larger than 0")
        self.num_outputs = num_outputs
        shape = (num_outputs,) if num_outputs > 1 else ()
        for name in _STATES[:-1]:
            self.add_state(name, torch.zeros(shape, dtype=torch.float32), dist_reduce_fx=None)
        self.add_state("n_total", torch.zeros((), dtype=torch.float32), dist_reduce_fx=None)

    def _validate(self, preds, target) -> None:
        _check_data_shape_to_num_outputs(preds, target, self.num_outputs)

    def _update(self, state, preds, target):
        return dict(zip(_STATES, _pearson_corrcoef_update(preds, target, *(state[k] for k in _STATES),
                                                          self.num_outputs)))

    def _merged_state(self, state):
        """The six states, with a leading world axis (after sync) folded into one running state."""
        values = tuple(state[k] for k in _STATES)
        return _final_aggregation(*values) if state["n_total"].ndim > 0 else values

    def _compute(self, state):
        _, _, var_x, var_y, corr_xy, n_total = self._merged_state(state)
        return _pearson_corrcoef_compute(var_x, var_y, corr_xy, n_total)
