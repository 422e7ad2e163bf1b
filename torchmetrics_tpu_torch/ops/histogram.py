"""Bincount and confusion-matrix updates (counterpart of ``torchmetrics_tpu/ops/histogram.py``).

The JAX package counts with a one-hot matmul on the TPU's matrix unit. The port counts with the
reference's own formulation, a bincount over ``target * C + pred`` (reference
``stat_scores.py:405-418``), which on a CUDA tensor runs through the hand-written kernel K1
(:mod:`torchmetrics_tpu_torch.ops.bincount`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops import bincount as _k1


def bincount(x: Tensor, length: int, dtype: torch.dtype = torch.int32) -> Tensor:
    """Count occurrences of each int value in ``[0, length)``; out-of-range values are dropped.

    Returns a tensor of shape ``(length,)`` (``histogram.py:45``).
    """
    return _k1.bincount(x.reshape(-1).contiguous(), length).to(dtype)


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
    ``target == ignore_index``; the kernel applies ``ignore_index`` in registers, so no mask
    is written for it. ``weights`` other than 0 and 1 raise: the weighted count waits for the
    weighted-histogram kernel K2.
    """
    mask = None
    if weights is not None:
        mask = weights.reshape(-1)
        if mask.dtype != torch.bool:
            if bool(((mask != 0) & (mask != 1)).any()):
                raise NotImplementedError(
                    "confusion_matrix_update counts 0/1 weights only; weighted counts arrive with kernel K2"
                )
            mask = mask != 0
        mask = mask.contiguous()
    cm = _k1.confusion_counts(
        preds.reshape(-1).contiguous(), target.reshape(-1).contiguous(), num_classes, mask, ignore_index
    )
    return cm.to(dtype)
