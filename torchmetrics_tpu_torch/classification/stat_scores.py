"""Stateful multiclass stat scores (counterpart of ``torchmetrics_tpu/classification/stat_scores.py``:
``_AbstractStatScores`` and ``MulticlassStatScores``, ``:33-145``)."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    CountType,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_compute,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
)
from torchmetrics_tpu_torch.metric import Metric


class _AbstractStatScores(Metric):
    """Shared state layout: int64 sum states for global, cat list states for samplewise
    (reference ``stat_scores.py:50-88``)."""

    def _create_state(self, size: int, multidim_average: str = "global") -> None:
        for name in ("tp", "fp", "tn", "fn"):
            if multidim_average == "samplewise":
                self.add_state(name, [], dist_reduce_fx="cat")
            else:
                self.add_state(name, torch.zeros(size if size > 1 else (), dtype=CountType), dist_reduce_fx="sum")

    def _merge_counts(self, state: Dict[str, Tensor], tp, fp, tn, fn) -> Dict[str, Tensor]:
        if self.multidim_average == "samplewise":
            return {"tp": tp, "fp": fp, "tn": tn, "fn": fn}  # appended to the list states
        return {"tp": state["tp"] + tp, "fp": state["fp"] + fp, "tn": state["tn"] + tn, "fn": state["fn"] + fn}


class MulticlassStatScores(_AbstractStatScores):
    """Reference ``classification/stat_scores.py:195``."""

    is_differentiable = False
    higher_is_better = None

    def __init__(
        self,
        num_classes: int,
        top_k: int = 1,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.top_k = top_k
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=num_classes, multidim_average=multidim_average)

    def _validate(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(
                preds, target, self.num_classes, self.multidim_average, self.ignore_index, self.top_k
            )

    def _update(self, state, preds, target):
        preds, target = _multiclass_stat_scores_format(preds, target, self.top_k)
        tp, fp, tn, fn = _multiclass_stat_scores_update(
            preds, target, self.num_classes, self.top_k, self.multidim_average, self.ignore_index
        )
        return self._merge_counts(state, tp, fp, tn, fn)

    def _compute(self, state):
        return _multiclass_stat_scores_compute(
            state["tp"], state["fp"], state["tn"], state["fn"], self.average, self.multidim_average
        )
