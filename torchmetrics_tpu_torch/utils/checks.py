"""Input checks (counterpart of ``torchmetrics_tpu/utils/checks.py``, reference ``checks.py:39``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor


def capturing(x: Tensor) -> bool:
    """Whether the stream of ``x``'s device is being captured into a CUDA graph, where the host
    cannot read the device: a check that reads it is skipped, as the JAX package skips host checks
    under trace."""
    return x.is_cuda and torch.cuda.is_current_stream_capturing()


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    """Raise if shapes differ."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {tuple(preds.shape)} and"
            f" {tuple(target.shape)}."
        )


def _not_binary(x: Tensor, ignore_index: Optional[int] = None) -> Tensor:
    bad = (x != 0) & (x != 1)
    return bad if ignore_index is None else bad & (x != ignore_index)


def _check_binary_target(target: Tensor, ignore_index: Optional[int] = None, preds: Optional[Tensor] = None) -> None:
    """Raise unless every target is 0, 1 or ``ignore_index`` and, when ``preds`` (a label tensor)
    is given, every pred is 0 or 1. One read of the device; the values are listed, as the JAX
    package lists them, only when some are not allowed."""
    flags = _not_binary(target, ignore_index).any()
    if preds is not None:
        flags = torch.stack([flags, _not_binary(preds).any()])
    bad_target, bad_preds = (bool(flags), False) if preds is None else flags.tolist()
    if bad_target:
        allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
        raise RuntimeError(
            f"Detected the following values in `target`: {sorted(torch.unique(target).tolist())} but expected only"
            f" the following values {sorted(allowed)}."
        )
    if bad_preds:
        raise RuntimeError(
            f"Detected the following values in `preds`: {sorted(torch.unique(preds).tolist())} but expected only"
            " the following values [0,1] since preds is a label tensor."
        )
