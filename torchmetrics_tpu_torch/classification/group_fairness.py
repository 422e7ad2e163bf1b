"""Group fairness (counterpart of ``torchmetrics_tpu/classification/group_fairness.py``:
``_AbstractGroupStatScores:23``, ``BinaryGroupStatRates:41``, ``BinaryFairness:74``).

The state is JAX's float32 ``(num_groups, 4)`` ``[tp, fp, tn, fn]`` sum (``:27``), counted by one
K1 launch per update. ``BinaryFairness`` keeps ``jit_compute = False`` (``:80``): the keys of its
result come from the ``argmin``/``argmax`` of the state, read on the host, so its compute, and
so its ``forward``, runs eagerly and outside any graph; its ``update`` can still be captured
(``fast_update``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.group_fairness import (
    _binary_groups_stat_scores_update,
    _compute_binary_demographic_parity,
    _compute_binary_equal_opportunity,
    _group_rates,
    _groups_validation,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.metric import Metric

_FAIRNESS_TASKS = ("demographic_parity", "equal_opportunity", "all")


class _AbstractGroupStatScores(Metric):
    """The shared ``(num_groups, 4)`` ``[tp, fp, tn, fn]`` sum state."""

    is_differentiable = False
    higher_is_better = False
    full_state_update = False

    def __init__(self, num_groups: int, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        if not isinstance(num_groups, int) or num_groups < 2:
            raise ValueError(f"Argument `num_groups` must be an int larger than 1, but got {num_groups}")
        self.num_groups = num_groups
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("stats", torch.zeros((num_groups, 4), dtype=torch.float32), dist_reduce_fx="sum")

    def _validate(self, preds, target, groups) -> None:
        if self.validate_args:
            _binary_stat_scores_tensor_validation(preds, target, "global", self.ignore_index)
            _groups_validation(groups, self.num_groups)

    def _update(self, state, preds, target, groups):
        stats = _binary_groups_stat_scores_update(preds, target, groups, self.num_groups, self.threshold,
                                                  self.ignore_index)
        return {"stats": state["stats"] + stats}


class BinaryGroupStatRates(_AbstractGroupStatScores):
    """Per-group tp/fp/tn/fn rates (reference ``group_fairness.py:59``)."""

    def _compute(self, state) -> Dict[str, Tensor]:
        return _group_rates(state["stats"], self.num_groups)


class BinaryFairness(_AbstractGroupStatScores):
    """Demographic parity and equal opportunity ratios (reference ``group_fairness.py:156``)."""

    jit_compute = False  # the result's keys depend on the state (argmin/argmax group ids)

    def __init__(self, num_groups: int, task: str = "all", threshold: float = 0.5,
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        if task not in _FAIRNESS_TASKS:
            raise ValueError(
                f"Expected argument `task` to either be ``demographic_parity``,"
                f"``equal_opportunity`` or ``all`` but got {task}."
            )
        super().__init__(num_groups, threshold, ignore_index, validate_args, **kwargs)
        self.task = task

    def _validate(self, preds, target, groups) -> None:
        if self.validate_args:
            if self.task != "demographic_parity":
                _binary_stat_scores_tensor_validation(preds, target, "global", self.ignore_index)
            _groups_validation(groups, self.num_groups)

    def _update(self, state, preds, target, groups):
        if self.task == "demographic_parity":
            target = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
        return super()._update(state, preds, target, groups)

    def _compute(self, state) -> Dict[str, Tensor]:
        out: Dict[str, Tensor] = {}
        if self.task in ("demographic_parity", "all"):
            out.update(_compute_binary_demographic_parity(state["stats"]))
        if self.task in ("equal_opportunity", "all"):
            out.update(_compute_binary_equal_opportunity(state["stats"]))
        return out
