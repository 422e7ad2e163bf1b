"""Data-movement helpers: dim-zero reductions, one-hot, top-k masks, bincount, closeness.

Counterpart of ``torchmetrics_tpu/utils/data.py`` (``dim_zero_*:24-48``, ``_flatten:52``,
``to_onehot:57``, ``select_topk:65``, ``to_categorical:81``, ``_bincount:86``, ``_cumsum:97``,
``_flexible_bincount:102``, ``allclose:112``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops import bincount as _k1


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


def _flatten(x: Sequence) -> list:
    """Flatten one level of nesting."""
    return [item for sublist in x for item in sublist]


def to_onehot(label_tensor: Tensor, num_classes: Optional[int] = None) -> Tensor:
    """``(N, ...)`` integer labels as an ``(N, C, ...)`` int32 one-hot (reference ``data.py:80``).

    ``num_classes=None`` reads the largest label from the device. A label outside ``[0, C)`` gets
    an all-zero column, as ``jax.nn.one_hot`` gives it.
    """
    if num_classes is None:
        num_classes = int(label_tensor.max()) + 1
    classes = torch.arange(num_classes, device=label_tensor.device).reshape((1, num_classes) + (1,) * (label_tensor.dim() - 1))
    return (label_tensor.unsqueeze(1) == classes).to(torch.int32)


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


def to_categorical(x: Tensor, argmax_dim: int = 1) -> Tensor:
    """Probabilities to class indices by argmax (reference ``data.py:142``)."""
    return torch.argmax(x, dim=argmax_dim)


def _bincount(x: Tensor, minlength: Optional[int] = None) -> Tensor:
    """int32 counts of each value of ``x`` in ``[0, minlength)``, through K1 (``ops/bincount.py``)
    on a CUDA tensor; values outside are dropped. ``minlength=None`` reads the largest value from
    the device (1 bin for an empty ``x``)."""
    if minlength is None:
        minlength = int(x.max()) + 1 if x.numel() else 1
    x = x.reshape(-1)
    if x.dtype not in (torch.int32, torch.int64):
        x = x.to(torch.int64)
    return _k1.bincount(x.contiguous(), minlength)


def _cumsum(x: Tensor, axis: int = 0, dtype: Optional[torch.dtype] = None) -> Tensor:
    """Cumulative sum along ``axis`` (reference ``data.py:200``). Integer inputs sum in int64, as
    ``torch.cumsum`` does, where the JAX package (64-bit mode off) sums in int32."""
    return torch.cumsum(x, dim=axis, dtype=dtype)


def _flexible_bincount(x: Tensor) -> Tensor:
    """int32 counts of the values present in ``x``, in ascending order of value (reference
    ``data.py:212``); the number of distinct values comes back to the host, so this is for eager
    computes only."""
    values, inverse = torch.unique(x.reshape(-1), return_inverse=True)
    return _bincount(inverse, values.numel())


def allclose(t1: Tensor, t2: Tensor, atol: float = 1e-8) -> bool:
    """Shape and value closeness of two tensors, compared in float64 (reference ``data.py:231``)."""
    if t1.shape != t2.shape:
        return False
    return bool(torch.allclose(t1.to(torch.float64), t2.to(device=t1.device, dtype=torch.float64), atol=atol))
