"""Multilabel ranking metrics (counterpart of ``torchmetrics_tpu/functional/classification/ranking.py``).

Coverage error, label-ranking average precision and label-ranking loss, with sklearn's semantics,
as rank statistics built from compares and sums, the JAX package's own formulation:

- coverage error (``:62-71``) is an ``(N, L)`` compare against each row's least relevant score;
- label-ranking AP (``:92-111``) and ranking loss (``:132-145``) are ``(N, L, L)`` pairwise
  compares. The loss's ``einsum`` of 0/1 factors (``:140``) is here a boolean ``&`` and an integer
  sum: the same exact count, with no matmul that a TF32 setting could reach.

Nothing is chunked: at ``L = 80`` and 10,000 rows each pairwise intermediate is 64 MiB of bool
(256 MiB of float32 in the JAX package), well inside an H100's memory. Each update returns the
float32 sum over its rows and the row count as a float32 total.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import _as_tensor
from torchmetrics_tpu_torch.utils.checks import _check_binary_target, _check_same_shape
from torchmetrics_tpu_torch.utils.compute import _safe_divide


def _multilabel_ranking_arg_validation(num_labels: int, ignore_index: Optional[int] = None) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Argument `num_labels` must be an integer larger than 1, but got {num_labels}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Argument `ignore_index` must be either `None` or an integer, but got {ignore_index}")


def _multilabel_ranking_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if not preds.is_floating_point():
        raise ValueError(f"`preds` must be a float tensor, but got {preds.dtype}")
    if preds.shape[1] != num_labels:
        raise ValueError(f"Expected `preds.shape[1]={preds.shape[1]}` to equal num_labels {num_labels}")
    _check_binary_target(target, ignore_index)


def _format(preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int]) -> Tuple[Tensor, Tensor, Tensor]:
    """``(N, L)`` float32 scores, the float32 target with ignored entries at 0, and the valid mask."""
    preds = preds.reshape(-1, num_labels)
    target = target.reshape(-1, num_labels)
    if ignore_index is None:
        valid = torch.ones(target.shape, dtype=torch.bool, device=target.device)
    else:
        valid = target != ignore_index
        target = target.masked_fill(~valid, 0)
    return preds.to(torch.float32), target.to(torch.float32), valid


def _rows(preds: Tensor) -> Tensor:
    return torch.full((), float(preds.shape[0]), dtype=torch.float32, device=preds.device)


def _multilabel_coverage_error_update(preds: Tensor, target: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor]:
    """Per sample, the labels scored at least as high as the least relevant one (sklearn)."""
    relevant = (target > 0) & valid
    min_relevant = torch.amin(preds.masked_fill(~relevant, float("inf")), dim=-1)
    cov = torch.sum((preds >= min_relevant[:, None]) & valid, dim=-1).to(torch.float32)
    cov = cov.masked_fill(~torch.any(relevant, dim=-1), 0.0)
    return torch.sum(cov), _rows(preds)


def _multilabel_ranking_average_precision_update(preds: Tensor, target: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-sample LRAP (sklearn ``label_ranking_average_precision_score``)."""
    relevant = (target > 0) & valid
    ge = preds[:, None, :] >= preds[:, :, None]  # [n, i, j]: score_j >= score_i
    rank = torch.sum(ge & valid[:, None, :], dim=-1).to(torch.float32)
    l_rank = torch.sum(ge & relevant[:, None, :], dim=-1).to(torch.float32)
    per_label = _safe_divide(l_rank, rank).masked_fill(~relevant, 0.0)
    n_relevant = torch.sum(relevant, dim=-1).to(torch.float32)
    n_valid = torch.sum(valid, dim=-1).to(torch.float32)
    per_sample = _safe_divide(torch.sum(per_label, dim=-1), n_relevant)
    # samples with no relevant label, or only relevant ones, score 1.0 (sklearn)
    per_sample = per_sample.masked_fill((n_relevant == 0) | (n_relevant == n_valid), 1.0)
    return torch.sum(per_sample), _rows(preds)


def _multilabel_ranking_loss_update(preds: Tensor, target: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-sample ranking loss: the share of (relevant, irrelevant) pairs ordered wrongly."""
    relevant = (target > 0) & valid
    irrelevant = (target == 0) & valid
    le = preds[:, :, None] <= preds[:, None, :]  # [n, i, j]: score_i <= score_j
    bad = torch.sum(le & relevant[:, :, None] & irrelevant[:, None, :], dim=(1, 2)).to(torch.float32)
    denom = torch.sum(relevant, dim=-1).to(torch.float32) * torch.sum(irrelevant, dim=-1).to(torch.float32)
    per_sample = (bad / torch.clamp(denom, min=1.0)).masked_fill(denom <= 0, 0.0)
    return torch.sum(per_sample), _rows(preds)


def _ranking_entry(update, preds, target, num_labels: int, ignore_index: Optional[int], validate_args: bool) -> Tensor:
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_ranking_arg_validation(num_labels, ignore_index)
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    s, n = update(*_format(preds, target, num_labels, ignore_index))
    return _safe_divide(s, n)


def multilabel_coverage_error(preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None,
                              validate_args: bool = True) -> Tensor:
    """How far down the ranking one must go to cover every relevant label (reference ``ranking.py:107``)."""
    return _ranking_entry(_multilabel_coverage_error_update, preds, target, num_labels, ignore_index, validate_args)


def multilabel_ranking_average_precision(preds: Tensor, target: Tensor, num_labels: int,
                                         ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Label-ranking average precision (reference ``ranking.py:167``)."""
    return _ranking_entry(_multilabel_ranking_average_precision_update, preds, target, num_labels, ignore_index,
                          validate_args)


def multilabel_ranking_loss(preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None,
                            validate_args: bool = True) -> Tensor:
    """Label-ranking loss (reference ``ranking.py:227``)."""
    return _ranking_entry(_multilabel_ranking_loss_update, preds, target, num_labels, ignore_index, validate_args)
