"""Data-movement helpers: dim-zero reductions, top-k masks, closeness.

Counterpart of ``torchmetrics_tpu/utils/data.py`` (``dim_zero_*:24-48``, ``select_topk:65``,
``allclose:112``).
"""
from __future__ import annotations

from typing import List, Union

import torch
from torch import Tensor


def dim_zero_cat(x: Union[Tensor, List[Tensor]]) -> Tensor:
    """Concatenate a (possibly list-valued) state along dim 0."""
    if isinstance(x, Tensor):
        return x
    if not x:
        raise ValueError("No samples to concatenate")
    return torch.cat([torch.atleast_1d(e) for e in x], dim=0)


def dim_zero_sum(x: Tensor) -> Tensor:
    return torch.sum(x, dim=0)


def dim_zero_mean(x: Tensor) -> Tensor:
    return torch.mean(x, dim=0)


def dim_zero_max(x: Tensor) -> Tensor:
    return torch.max(x, dim=0).values


def dim_zero_min(x: Tensor) -> Tensor:
    return torch.min(x, dim=0).values


def select_topk(prob_tensor: Tensor, topk: int = 1, dim: int = 1) -> Tensor:
    """0/1 int32 mask of the top-k entries along ``dim`` (reference ``data.py:115``).

    ``topk == 1`` takes the first maximum, as ``jnp.argmax`` does.
    """
    if topk == 1:
        idx = torch.argmax(prob_tensor, dim=dim, keepdim=True)
    else:
        idx = torch.topk(prob_tensor, topk, dim=dim).indices
    mask = torch.zeros(prob_tensor.shape, dtype=torch.int32, device=prob_tensor.device)
    return mask.scatter_(dim, idx, 1)


def allclose(t1: Tensor, t2: Tensor, atol: float = 1e-8) -> bool:
    """Shape and value closeness of two tensors, compared in float64 (reference ``data.py:231``)."""
    if t1.shape != t2.shape:
        return False
    return bool(torch.allclose(t1.to(torch.float64), t2.to(device=t1.device, dtype=torch.float64), atol=atol))
