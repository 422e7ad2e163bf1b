"""Cosine similarity (counterpart of ``torchmetrics_tpu/functional/regression/cosine_similarity.py``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.utils import _check_same_shape


def _check_cosine_similarity_input(preds: Tensor, target: Tensor) -> None:
    """``cosine_similarity.py:13``: equal shapes, ``(N, D)``."""
    _check_same_shape(preds, target)
    if preds.ndim != 2:
        raise ValueError(
            f"Expected input to cosine similarity to be 2D tensors of shape `[N,D]`, but got {preds.ndim}D"
        )


def _cosine_similarity_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Row-wise cosine, a zero norm counted as 1 (``cosine_similarity.py:21``), then the reduction."""
    dot = torch.sum(preds * target, dim=-1)
    norm = torch.linalg.vector_norm(preds, dim=-1) * torch.linalg.vector_norm(target, dim=-1)
    sim = dot / torch.where(norm == 0, 1.0, norm)
    if reduction == "sum":
        return torch.sum(sim)
    if reduction == "mean":
        return torch.mean(sim)
    if reduction in ("none", None):
        return sim
    raise ValueError(f"Expected reduction to be one of `['sum', 'mean', 'none', None]` but got {reduction}")


def cosine_similarity(preds: Tensor, target: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Cosine similarity (``cosine_similarity.py:34``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import cosine_similarity
        >>> preds, target = torch.tensor([[1.0, 0.0], [1.0, 1.0]]), torch.tensor([[1.0, 0.0], [0.0, 1.0]])
        >>> print(f"{float(cosine_similarity(preds, target, reduction='mean')):.4f}")
        0.8536
    """
    _check_cosine_similarity_input(preds, target)
    return _cosine_similarity_compute(preds.to(torch.float32), target.to(torch.float32), reduction)
