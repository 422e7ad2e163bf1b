"""The validate → format → update pipelines producing tp/fp/tn/fn counts.

Counterpart of ``torchmetrics_tpu/functional/classification/_counts.py`` (``binary_counts:32``,
``multiclass_counts:48``, ``multilabel_counts:66``): the pipeline every stat-scores consumer
repeats, factored once.
"""
from __future__ import annotations

from typing import Optional, Tuple

from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _as_tensor,
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)

Counts = Tuple[Tensor, Tensor, Tensor, Tensor]


def binary_counts(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Counts:
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target = _binary_stat_scores_format(preds, target, threshold)
    return _binary_stat_scores_update(preds, target, multidim_average, ignore_index)


def multiclass_counts(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Counts:
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index, top_k)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    return _multiclass_stat_scores_update(preds, target, num_classes, top_k, multidim_average, ignore_index)


def multilabel_counts(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Counts:
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target = _multilabel_stat_scores_format(preds, target, num_labels, threshold)
    return _multilabel_stat_scores_update(preds, target, multidim_average, ignore_index)
