"""Stateful stat scores (counterpart of ``torchmetrics_tpu/classification/stat_scores.py``:
``_AbstractStatScores:33``, ``BinaryStatScores:64``, ``MulticlassStatScores:101``,
``MultilabelStatScores:148`` and the task wrapper ``StatScores:195``)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    CountType,
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_compute,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _check_task,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_compute,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_compute,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


class _AbstractStatScores(Metric):
    """Shared state layout: int64 sum states for global, cat list states for samplewise
    (reference ``stat_scores.py:50-88``)."""

    def _create_state(self, size: int, multidim_average: str = "global") -> None:
        for name in ("tp", "fp", "tn", "fn"):
            if multidim_average == "samplewise":
                self.add_state(name, [], dist_reduce_fx="cat")
            else:
                self.add_state(name, torch.zeros(size if size > 1 else (), dtype=CountType), dist_reduce_fx="sum")

    def _as_state(self, name: str, value: Any, list_dtype: Optional[torch.dtype] = None) -> Tensor:
        """Every state is a count, int64 in the list states of ``samplewise`` too."""
        return super()._as_state(name, value, CountType)

    def _merge_counts(self, state: Dict[str, Tensor], tp, fp, tn, fn) -> Dict[str, Tensor]:
        if self.multidim_average == "samplewise":
            return {"tp": tp, "fp": fp, "tn": tn, "fn": fn}  # appended to the list states
        return {"tp": state["tp"] + tp, "fp": state["fp"] + fp, "tn": state["tn"] + tn, "fn": state["fn"] + fn}


class BinaryStatScores(_AbstractStatScores):
    """Reference ``classification/stat_scores.py:91``. One K1 launch per update."""

    is_differentiable = False
    higher_is_better = None

    def __init__(
        self,
        threshold: float = 0.5,
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        self.threshold = threshold
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=1, multidim_average=multidim_average)

    def _validate(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_stat_scores_tensor_validation(preds, target, self.multidim_average, self.ignore_index)

    def _update(self, state, preds, target):
        preds, target = _binary_stat_scores_format(preds, target, self.threshold)
        tp, fp, tn, fn = _binary_stat_scores_update(preds, target, self.multidim_average, self.ignore_index)
        return self._merge_counts(state, tp, fp, tn, fn)

    def _compute(self, state):
        return _binary_stat_scores_compute(state["tp"], state["fp"], state["tn"], state["fn"], self.multidim_average)


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


class MultilabelStatScores(_AbstractStatScores):
    """Reference ``classification/stat_scores.py:346``. One K1 launch per update."""

    is_differentiable = False
    higher_is_better = None

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        multidim_average: str = "global",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        self.num_labels = num_labels
        self.threshold = threshold
        self.average = average
        self.multidim_average = multidim_average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_state(size=num_labels, multidim_average=multidim_average)

    def _validate(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_stat_scores_tensor_validation(
                preds, target, self.num_labels, self.multidim_average, self.ignore_index
            )

    def _update(self, state, preds, target):
        preds, target = _multilabel_stat_scores_format(preds, target, self.num_labels, self.threshold)
        tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, self.multidim_average, self.ignore_index)
        return self._merge_counts(state, tp, fp, tn, fn)

    def _compute(self, state):
        return _multilabel_stat_scores_compute(
            state["tp"], state["fp"], state["tn"], state["fn"], self.average, self.multidim_average
        )


def _stat_scores_task_metric(
    task: str, classes: Sequence[type], threshold: float, num_classes: Optional[int], num_labels: Optional[int],
    average: Optional[str], top_k: Optional[int], kwargs: Dict[str, Any], lead: tuple = (),
) -> Metric:
    """The binary, multiclass or multilabel class of ``classes`` for ``task``, the stat-score task
    wrappers' shared body; ``lead`` holds the arguments before the task's own (F-beta's ``beta``)."""
    binary, multiclass, multilabel = classes
    task = _check_task(task, num_classes, num_labels, top_k)
    if task == ClassificationTask.BINARY:
        return binary(*lead, threshold, **kwargs)
    if task == ClassificationTask.MULTICLASS:
        return multiclass(*lead, num_classes, top_k, average, **kwargs)
    return multilabel(*lead, num_labels, threshold, average, **kwargs)


class StatScores(_ClassificationTaskWrapper):
    """Task dispatcher: ``StatScores(task="binary"|...)`` (reference ``stat_scores.py:491``)."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        classes = (BinaryStatScores, MulticlassStatScores, MultilabelStatScores)
        return _stat_scores_task_metric(task, classes, threshold, num_classes, num_labels, average, top_k, kwargs)
