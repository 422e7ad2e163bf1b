"""Bincount, weighted histogram and confusion-matrix updates (counterpart of ``torchmetrics_tpu/ops/histogram.py``).

The JAX package counts with a one-hot matmul on the TPU's matrix unit. The port counts with the
reference's own formulation, a bincount over ``target * C + pred`` (reference
``stat_scores.py:405-418``). On a CUDA tensor, counts of 0/1 weights run through the int32
kernel K1 (:mod:`torchmetrics_tpu_torch.ops.bincount`), and weighted counts through the float32
histogram-pair kernel K2 (:mod:`torchmetrics_tpu_torch.ops.hist_pair`) with one weight stream.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops import bincount as _k1
from torchmetrics_tpu_torch.ops import hist_pair as _k2


def bincount(x: Tensor, length: int, dtype: torch.dtype = torch.int32) -> Tensor:
    """Count occurrences of each int value in ``[0, length)``; out-of-range values are dropped.

    Returns a tensor of shape ``(length,)`` (``histogram.py:45``).
    """
    return _k1.bincount(x.reshape(-1).contiguous(), length).to(dtype)


def bincount_weighted(
    x: Tensor, length: int, weights: Optional[Tensor] = None, dtype: Optional[torch.dtype] = None
) -> Tensor:
    """Weighted bincount; ``weights=None`` counts 1 per element (``histogram.py:60``).

    Out-of-range values are dropped. Unweighted counts are int32 (K1); weighted ones are float32
    sums (K2), returned in ``dtype`` or else in the dtype of ``weights``, as in the JAX package.
    """
    if weights is None:
        return bincount(x, length, dtype or torch.int32)
    w = weights.reshape(-1).to(torch.float32).contiguous()
    return _k2.hist_pair(_index(x), w, None, length)[0].to(dtype or weights.dtype)


def hist_pair(idx: Tensor, pos_w: Tensor, neg_w: Tensor, length: int) -> Tensor:
    """``(2, length)`` float32 weighted counts of ``idx`` under two weight streams, one pass:
    the curve sketch's accumulation (``histogram.py:86``). Out-of-range indices are dropped;
    exact to 2^24 unit weights per bin."""
    pos = pos_w.reshape(-1).to(torch.float32).contiguous()
    neg = neg_w.reshape(-1).to(torch.float32).contiguous()
    return _k2.hist_pair(_index(idx), pos, neg, length)


def _index(x: Tensor) -> Tensor:
    x = x.reshape(-1)
    return (x if x.dtype in (torch.int32, torch.int64) else x.to(torch.int64)).contiguous()


def confusion_matrix_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    weights: Optional[Tensor] = None,
    ignore_index: Optional[int] = None,
    dtype: torch.dtype = torch.int32,
) -> Tensor:
    """``(C, C)`` confusion-matrix contribution of a batch of int labels (``histogram.py:119``).

    Rows are targets and columns are predictions. A sample is dropped when ``target`` or
    ``preds`` falls outside ``[0, C)``, when its ``weights`` entry is 0, or when
    ``target == ignore_index``. Without weights, or with 0/1 weights, the count is int32 and
    exact (K1, which applies ``ignore_index`` in registers). Other weights are summed in
    float32 (K2) and cast to ``dtype``, which truncates towards zero for an integer ``dtype``,
    as the JAX package's cast does.
    """
    preds = preds.reshape(-1).contiguous()
    target = target.reshape(-1).contiguous()
    mask = None
    if weights is not None:
        mask = weights.reshape(-1)
        if mask.dtype != torch.bool:
            if bool(((mask != 0) & (mask != 1)).any()):
                return _weighted_confusion(preds, target, num_classes, mask, ignore_index).to(dtype)
            mask = mask != 0
        mask = mask.contiguous()
    return _k1.confusion_counts(preds, target, num_classes, mask, ignore_index).to(dtype)


def _weighted_confusion(
    preds: Tensor, target: Tensor, num_classes: int, weights: Tensor, ignore_index: Optional[int]
) -> Tensor:
    """float32 ``(C, C)`` sums of ``weights`` over the fused index ``target * C + pred``."""
    if weights.numel() != target.numel():
        raise ValueError(f"`weights` holds {weights.numel()} values, expected {target.numel()}")
    p, t = preds.to(torch.int64), target.to(torch.int64)
    keep = (t >= 0) & (t < num_classes) & (p >= 0) & (p < num_classes)
    if ignore_index is not None:
        keep &= t != ignore_index
    fused = torch.where(keep, t * num_classes + p, -1)
    w = weights.to(torch.float32).contiguous()
    return _k2.hist_pair(fused, w, None, num_classes * num_classes)[0].reshape(num_classes, num_classes)
