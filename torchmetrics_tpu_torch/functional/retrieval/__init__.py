"""Functional retrieval metrics, one query per call (counterpart of
``torchmetrics_tpu/functional/retrieval/__init__.py``, reference ``src/torchmetrics/functional/retrieval/``).

Each entry takes the scores and relevance of one query as tensors and returns a tensor on their
device; the kernels are those of the rectangle path (``_kernels.py``) on a single row.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.retrieval._kernels import (
    average_precision_kernel,
    fall_out_kernel,
    hit_rate_kernel,
    ndcg_kernel,
    precision_kernel,
    r_precision_kernel,
    recall_kernel,
    reciprocal_rank_kernel,
)
from torchmetrics_tpu_torch.utils.checks import _check_retrieval_functional_inputs


def _prep(preds: Tensor, target: Tensor, graded: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    preds, target = _check_retrieval_functional_inputs(preds, target, allow_non_binary_target=graded)
    if preds.dtype == torch.float64:  # the JAX package's scores are float32 (64-bit mode off)
        preds = preds.to(torch.float32)
    mask = torch.ones(preds.shape, dtype=torch.float32, device=preds.device)
    return preds, target.to(torch.float32), mask


def _check_top_k(top_k: Optional[int]) -> None:
    if top_k is not None and not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")


def retrieval_average_precision(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """AP for a single query (reference ``functional/retrieval/average_precision.py``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_average_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> print(f"{float(retrieval_average_precision(preds, target)):.4f}")
        0.8333
    """
    _check_top_k(top_k)
    preds, target, mask = _prep(preds, target)
    return average_precision_kernel(preds, target, mask, top_k)


def retrieval_reciprocal_rank(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """Reciprocal rank for a single query (reference ``reciprocal_rank.py``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_reciprocal_rank
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> print(f"{float(retrieval_reciprocal_rank(preds, target)):.4f}")
        1.0000
    """
    _check_top_k(top_k)
    preds, target, mask = _prep(preds, target)
    return reciprocal_rank_kernel(preds, target, mask, top_k)


def retrieval_precision(
    preds: Tensor, target: Tensor, top_k: Optional[int] = None, adaptive_k: bool = False
) -> Tensor:
    """precision@k for a single query (reference ``precision.py``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> print(f"{float(retrieval_precision(preds, target, top_k=2)):.4f}")
        0.5000
    """
    _check_top_k(top_k)
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    preds, target, mask = _prep(preds, target)
    return precision_kernel(preds, target, mask, top_k, adaptive_k)


def retrieval_recall(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """recall@k for a single query (reference ``recall.py``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_recall
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> print(f"{float(retrieval_recall(preds, target, top_k=2)):.4f}")
        0.5000
    """
    _check_top_k(top_k)
    preds, target, mask = _prep(preds, target)
    return recall_kernel(preds, target, mask, top_k)


def retrieval_fall_out(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """fall-out@k for a single query (reference ``fall_out.py``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_fall_out
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> print(f"{float(retrieval_fall_out(preds, target)):.4f}")
        1.0000
    """
    _check_top_k(top_k)
    preds, target, mask = _prep(preds, target)
    return fall_out_kernel(preds, target, mask, top_k)


def retrieval_hit_rate(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """hit-rate@k for a single query (reference ``hit_rate.py``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_hit_rate
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> print(f"{float(retrieval_hit_rate(preds, target)):.4f}")
        1.0000
    """
    _check_top_k(top_k)
    preds, target, mask = _prep(preds, target)
    return hit_rate_kernel(preds, target, mask, top_k)


def retrieval_r_precision(preds: Tensor, target: Tensor) -> Tensor:
    """R-precision for a single query (reference ``r_precision.py``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_r_precision
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> print(f"{float(retrieval_r_precision(preds, target)):.4f}")
        0.5000
    """
    preds, target, mask = _prep(preds, target)
    return r_precision_kernel(preds, target, mask)


def retrieval_normalized_dcg(preds: Tensor, target: Tensor, top_k: Optional[int] = None) -> Tensor:
    """NDCG@k for a single query, graded relevance allowed (reference ``ndcg.py``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_normalized_dcg
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> print(f"{float(retrieval_normalized_dcg(preds, target)):.4f}")
        0.9197
    """
    _check_top_k(top_k)
    preds, target, mask = _prep(preds, target, graded=True)
    return ndcg_kernel(preds, target, mask, top_k)


def retrieval_precision_recall_curve(
    preds: Tensor, target: Tensor, max_k: Optional[int] = None, adaptive_k: bool = False
) -> Tuple[Tensor, Tensor, Tensor]:
    """(precisions, recalls, top_k values) for k = 1..max_k (reference ``precision_recall_curve.py``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import retrieval_precision_recall_curve
        >>> preds = torch.tensor([0.9, 0.8, 0.7, 0.6, 0.5])
        >>> target = torch.tensor([1, 0, 1, 0, 1])
        >>> prec, rec, top_k = retrieval_precision_recall_curve(preds, target, max_k=4)
        >>> [round(float(p), 4) for p in prec]
        [1.0, 0.5, 0.6667, 0.5]
        >>> top_k.tolist()
        [1, 2, 3, 4]
    """
    if not isinstance(adaptive_k, bool):
        raise ValueError("`adaptive_k` has to be a boolean")
    preds, target, mask = _prep(preds, target)
    n = preds.shape[0]
    if max_k is None:
        max_k = n
    if not (isinstance(max_k, int) and max_k > 0):
        raise ValueError('`max_k` must be a positive integer or None')
    if not adaptive_k:
        ks = list(range(1, max_k + 1))
    else:
        ks = list(range(1, min(max_k, n) + 1))
    precisions = torch.stack([precision_kernel(preds, target, mask, k, adaptive_k) for k in ks])
    recalls = torch.stack([recall_kernel(preds, target, mask, k) for k in ks])
    return precisions, recalls, torch.tensor(ks, device=preds.device)


__all__ = [
    "retrieval_average_precision",
    "retrieval_fall_out",
    "retrieval_hit_rate",
    "retrieval_normalized_dcg",
    "retrieval_precision",
    "retrieval_precision_recall_curve",
    "retrieval_r_precision",
    "retrieval_recall",
    "retrieval_reciprocal_rank",
]
