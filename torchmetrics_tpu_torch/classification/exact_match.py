"""Exact match (counterpart of ``torchmetrics_tpu/classification/exact_match.py``: ``_AbstractExactMatch:26``,
``MulticlassExactMatch:44``, ``MultilabelExactMatch:76`` and the task wrapper ``ExactMatch:111``).

``samplewise`` keeps ``cat`` list states of per-sample float32 values, ``global`` float32
``correct``/``total`` sums (``:29-33``), as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.exact_match import (
    _exact_match_reduce,
    _multiclass_exact_match_update,
    _multilabel_exact_match_update,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoBinary


class _AbstractExactMatch(Metric):
    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def _create_state(self, multidim_average: str) -> None:
        for name in ("correct", "total"):
            if multidim_average == "samplewise":
                self.add_state(name, [], dist_reduce_fx="cat")
            else:
                self.add_state(name, torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _merge(self, state, correct, total):
        if self.multidim_average == "samplewise":
            return {"correct": correct, "total": total}
        return {"correct": state["correct"] + correct, "total": state["total"] + total}

    def _compute(self, state):
        return _exact_match_reduce(state["correct"], state["total"])


class MulticlassExactMatch(_AbstractExactMatch):
    """Multiclass exact match (reference ``exact_match.py:44``)."""
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, num_classes: int, multidim_average: str = "global",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_stat_scores_arg_validation(num_classes, 1, None, multidim_average, ignore_index)
        self.num_classes = num_classes
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def _validate(self, preds, target) -> None:
        if self.validate_args:
            _multiclass_stat_scores_tensor_validation(preds, target, self.num_classes, self.multidim_average,
                                                      self.ignore_index)

    def _update(self, state, preds, target):
        preds, target = _multiclass_stat_scores_format(preds, target, 1)
        return self._merge(state, *_multiclass_exact_match_update(preds, target, self.multidim_average,
                                                                  self.ignore_index))


class MultilabelExactMatch(_AbstractExactMatch):
    """Multilabel exact match (reference ``exact_match.py:198``)."""
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, num_labels: int, threshold: float = 0.5, multidim_average: str = "global",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(multidim_average)

    def _validate(self, preds, target) -> None:
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(preds, target, self.num_labels, self.multidim_average,
                                                      self.ignore_index)

    def _update(self, state, preds, target):
        preds, target = _multilabel_stat_scores_format(preds, target, self.num_labels, self.threshold)
        return self._merge(state, *_multilabel_exact_match_update(preds, target, self.multidim_average,
                                                                  self.ignore_index))


class ExactMatch(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``exact_match.py:367``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch import ExactMatch
        >>> metric = ExactMatch(task="multilabel", num_labels=2, device="cpu")
        >>> metric.update(torch.tensor([[0, 1], [1, 1]]), torch.tensor([[0, 1], [0, 1]]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.5000
    """

    def __new__(  # type: ignore[misc]
        cls, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
        num_labels: Optional[int] = None, multidim_average: str = "global",
        ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ):
        task = ClassificationTaskNoBinary.from_str(task)
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoBinary.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` must be `int` but `{type(num_classes)} was passed.`")
            return MulticlassExactMatch(num_classes, **kwargs)
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` must be `int` but `{type(num_labels)} was passed.`")
        return MultilabelExactMatch(num_labels, threshold, **kwargs)
