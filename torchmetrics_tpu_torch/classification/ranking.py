"""Multilabel ranking metrics (counterpart of ``torchmetrics_tpu/classification/ranking.py``:
``_RankingBase:21``, ``MultilabelCoverageError:56``, ``MultilabelRankingAveragePrecision:63``,
``MultilabelRankingLoss:72``), on float32 ``measure``/``total`` sum states (``:40-41``)."""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from torchmetrics_tpu_torch.functional.classification.ranking import (
    _format,
    _multilabel_coverage_error_update,
    _multilabel_ranking_arg_validation,
    _multilabel_ranking_average_precision_update,
    _multilabel_ranking_loss_update,
    _multilabel_ranking_tensor_validation,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.compute import _safe_divide


class _RankingBase(Metric):
    is_differentiable = False
    full_state_update = False
    _update_fn: Callable  # set by each subclass

    def __init__(self, num_labels: int, ignore_index: Optional[int] = None, validate_args: bool = True,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_ranking_arg_validation(num_labels, ignore_index)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measure", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _validate(self, preds, target) -> None:
        if self.validate_args:
            _multilabel_ranking_tensor_validation(preds, target, self.num_labels, self.ignore_index)

    def _update(self, state, preds, target):
        measure, n = type(self)._update_fn(*_format(preds, target, self.num_labels, self.ignore_index))
        return {"measure": state["measure"] + measure, "total": state["total"] + n}

    def _compute(self, state):
        return _safe_divide(state["measure"], state["total"])


class MultilabelCoverageError(_RankingBase):
    """Coverage error (reference ``classification/ranking.py:40``)."""

    higher_is_better = False
    _update_fn = staticmethod(_multilabel_coverage_error_update)


class MultilabelRankingAveragePrecision(_RankingBase):
    """Label-ranking average precision (reference ``classification/ranking.py:160``)."""

    higher_is_better = True
    _update_fn = staticmethod(_multilabel_ranking_average_precision_update)


class MultilabelRankingLoss(_RankingBase):
    """Label-ranking loss (reference ``classification/ranking.py:280``)."""

    higher_is_better = False
    _update_fn = staticmethod(_multilabel_ranking_loss_update)
