"""Exact match (counterpart of ``torchmetrics_tpu/functional/classification/exact_match.py``).

A sample counts when every position (multiclass, ``:32``) or every label at a position
(multilabel, ``:64``) matches: ``torch.all`` over that axis, with ignored entries counted as
matches. ``global`` gives float32 ``(correct, total)`` sums, ``samplewise`` per-sample float32
values. The counts are built from compares and sums alone (no host value), so they run inside a
captured step. The task entry dispatches on ``ClassificationTaskNoBinary`` (``:96-101``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _as_tensor,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.utils.compute import _safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoBinary


def _exact_match_reduce(correct: Tensor, total: Tensor) -> Tensor:
    return _safe_divide(correct, total)


def _multiclass_exact_match_update(
    preds: Tensor, target: Tensor, multidim_average: str = "global", ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    """All positions of a sample must match (reference ``exact_match.py:46-77``); ``(N, S)`` labels."""
    match = preds == target
    if ignore_index is not None:
        match |= target == ignore_index
    correct = torch.all(match, dim=1).to(torch.float32)
    if multidim_average == "global":
        return torch.sum(correct), torch.full((), float(correct.shape[0]), dtype=torch.float32, device=correct.device)
    return correct, torch.ones_like(correct)


def multiclass_exact_match(preds: Tensor, target: Tensor, num_classes: int, multidim_average: str = "global",
                           ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Multiclass exact match (reference ``exact_match.py:80``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import multiclass_exact_match
        >>> print(f"{float(multiclass_exact_match(torch.tensor([[0, 1], [1, 1]]), torch.tensor([[0, 1], [0, 1]]), 2)):.4f}")
        0.5000
    """
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, 1, None, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, 1)
    correct, total = _multiclass_exact_match_update(preds, target, multidim_average, ignore_index)
    return _exact_match_reduce(correct, total)


def _multilabel_exact_match_update(
    preds: Tensor, target: Tensor, multidim_average: str = "global", ignore_index: Optional[int] = None
) -> Tuple[Tensor, Tensor]:
    """``(N, L, S)``: all labels must match at each (sample, position)."""
    match = preds == target
    if ignore_index is not None:
        match |= target == ignore_index
    correct = torch.all(match, dim=1).to(torch.float32)  # (N, S)
    n, s = correct.shape
    if multidim_average == "global":
        return torch.sum(correct), torch.full((), float(n * s), dtype=torch.float32, device=correct.device)
    return torch.sum(correct, dim=1), torch.full((n,), float(s), dtype=torch.float32, device=correct.device)


def multilabel_exact_match(preds: Tensor, target: Tensor, num_labels: int, threshold: float = 0.5,
                           multidim_average: str = "global", ignore_index: Optional[int] = None,
                           validate_args: bool = True) -> Tensor:
    """Multilabel exact match (reference ``exact_match.py:224``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target = _multilabel_stat_scores_format(preds, target, num_labels, threshold)
    correct, total = _multilabel_exact_match_update(preds, target, multidim_average, ignore_index)
    return _exact_match_reduce(correct, total)


def exact_match(preds: Tensor, target: Tensor, task: str, num_classes: Optional[int] = None,
                num_labels: Optional[int] = None, threshold: float = 0.5, multidim_average: str = "global",
                ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Task-dispatching exact match (reference ``exact_match.py:355``)."""
    task = ClassificationTaskNoBinary.from_str(task)
    if task == ClassificationTaskNoBinary.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` must be `int` but `{type(num_classes)} was passed.`")
        return multiclass_exact_match(preds, target, num_classes, multidim_average, ignore_index, validate_args)
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` must be `int` but `{type(num_labels)} was passed.`")
    return multilabel_exact_match(preds, target, num_labels, threshold, multidim_average, ignore_index, validate_args)
