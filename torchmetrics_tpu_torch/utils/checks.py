"""Input checks (counterpart of ``torchmetrics_tpu/utils/checks.py``, reference ``checks.py:39``)."""
from __future__ import annotations

from typing import Optional, Tuple

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


def _is_integer(x: Tensor) -> bool:
    return not (x.is_floating_point() or x.is_complex() or x.dtype == torch.bool)


def _check_binary_relevance(target: Tensor, ignore_index: Optional[int] = None) -> None:
    """Raise unless every target that is not ``ignore_index`` lies in ``[0, 1]``; one read of the
    device. NaN targets pass, as they pass numpy's ``max() > 1 or min() < 0``."""
    t = target.to(torch.uint8) if target.dtype == torch.bool else target
    bad = (t > 1) | (t < 0)
    if ignore_index is not None:
        bad &= t != ignore_index
    if bool(bad.any()):
        raise ValueError("`target` must contain `binary` values")


def _check_retrieval_inputs(
    indexes: Tensor, preds: Tensor, target: Tensor, allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Validate and flatten retrieval triplets (``torchmetrics_tpu/utils/checks.py:54``, reference
    ``checks.py:540``). The target check reads the device once; it runs in ``update``, outside any
    graph. The JAX package skips it under trace, so a jitted update there accepts a target of 2."""
    if indexes.shape != preds.shape or preds.shape != target.shape:
        raise ValueError("`indexes`, `preds` and `targets` must be of the same shape")
    if not _is_integer(indexes):
        raise ValueError("`indexes` must be a tensor of long integers")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    indexes, preds, target = indexes.reshape(-1), preds.reshape(-1), target.reshape(-1)
    if not allow_non_binary_target and target.numel() and not capturing(target):
        _check_binary_relevance(target, ignore_index)
    return indexes, preds, target


def _check_retrieval_functional_inputs(
    preds: Tensor, target: Tensor, allow_non_binary_target: bool = False
) -> Tuple[Tensor, Tensor]:
    """Validate and flatten one query's ``(preds, target)`` (``torchmetrics_tpu/utils/checks.py:75``)."""
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    preds, target = preds.reshape(-1), target.reshape(-1)
    if not allow_non_binary_target and target.numel() and not capturing(target):
        _check_binary_relevance(target)
    return preds, target
