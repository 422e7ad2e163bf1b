"""Multiclass stat scores (tp/fp/tn/fn), the foundation of the classification stack.

Counterpart of ``torchmetrics_tpu/functional/classification/stat_scores.py`` (multiclass
``:163-350``) with the reference's decomposition ``_arg_validation`` → ``_tensor_validation`` →
``_format`` → ``_update`` → ``_compute``. Binary and multilabel come in a later slice.

The global ``top_k == 1`` update is one confusion-matrix count over ``target * C + pred``, which
on a CUDA tensor runs through kernel K1; ``ignore_index`` is applied inside that count. Counts
are int64. Validation runs on the host and reads the labels' range from the device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops.histogram import confusion_matrix_update
from torchmetrics_tpu_torch.utils.data import select_topk

CountType = torch.int64


def _as_tensor(x) -> Tensor:
    return x if isinstance(x, Tensor) else torch.as_tensor(x)


def _as_index(x: Tensor) -> Tensor:
    """Labels as int32 or int64, the kernel's index types; others are widened to int64."""
    return x if x.dtype in (torch.int32, torch.int64) else x.to(torch.int64)


def _one_hot(x: Tensor, num_classes: int, dim: int) -> Tensor:
    """int64 one-hot inserted at ``dim``; values outside ``[0, C)`` give an all-zero row, as in JAX."""
    classes = torch.arange(num_classes, device=x.device)
    shape = [1] * (x.ndim + 1)
    shape[dim] = num_classes
    return (x.unsqueeze(dim) == classes.reshape(shape)).to(CountType)


def _multiclass_stat_scores_arg_validation(
    num_classes: int,
    top_k: int = 1,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Argument `num_classes` must be an integer larger than 1, but got {num_classes}")
    if not isinstance(top_k, int) and top_k < 1:
        raise ValueError(f"Expected argument `top_k` to be an integer larger than or equal to 1, but got {top_k}")
    if top_k > num_classes:
        raise ValueError(
            f"Expected argument `top_k` to be smaller or equal to `num_classes` but got {top_k} and {num_classes}"
        )
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average}, but got {average}")
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ['global', 'samplewise'], but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Argument `ignore_index` must be either `None` or an integer, but got {ignore_index}")


def _value_range(x: Tensor) -> Tuple[int, int]:
    lo, hi = torch.stack(torch.aminmax(x)).tolist()
    return lo, hi


def _multiclass_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    top_k: int = 1,
) -> None:
    if preds.ndim == target.ndim + 1:
        if not preds.is_floating_point():
            raise ValueError("If `preds` have one dimension more than `target`, `preds` must be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError("If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                             " equal to number of classes.")
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
        if multidim_average != "global" and preds.ndim < 3:
            raise ValueError("If `preds` have one dimension more than `target`, the shape of `preds` should"
                             " be at least 3D when multidim_average is set to `samplewise`")
    elif preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError("The `preds` and `target` should have the same shape,")
        if multidim_average != "global" and preds.ndim < 2:
            raise ValueError("When `preds` and `target` have the same shape, the shape should be at least 2D"
                             " when multidim_average is set to `samplewise`")
        if top_k != 1:
            raise ValueError("If `preds` and `target` have the same shape, then `top_k` should be set to 1.")
    else:
        raise ValueError("Either `preds` and `target` both should have the (same) shape (N, ...), or `target`"
                         " should be (N, ...) and `preds` should be (N, C, ...).")
    t = target if ignore_index is None else target[target != ignore_index]
    if t.numel():
        lo, hi = _value_range(t)
        if (lo < 0 or hi >= num_classes) and not (ignore_index is not None and ignore_index in (lo, hi)):
            raise RuntimeError(
                f"Detected more unique values in `target` than expected. Expected only {num_classes} but found"
                f" values in range [{lo}, {hi}]."
            )
    if not preds.is_floating_point() and preds.numel():
        lo, hi = _value_range(preds)
        if lo < 0 or hi >= num_classes:
            raise RuntimeError(
                f"Detected more unique values in `preds` than expected. Expected only {num_classes} but found"
                f" values in range [{lo}, {hi}]."
            )


def _multiclass_stat_scores_format(preds: Tensor, target: Tensor, top_k: int = 1) -> Tuple[Tensor, Tensor]:
    """(N, C, S...) float preds → (N, S) labels (``top_k == 1``) or (N, C, S) scores; extra dims flattened."""
    if preds.is_floating_point() and preds.ndim == target.ndim + 1:
        if top_k == 1:
            preds = torch.argmax(preds, dim=1).reshape(preds.shape[0], -1)
        else:
            preds = preds.reshape(preds.shape[0], preds.shape[1], -1)
    else:
        preds = _as_index(preds.reshape(preds.shape[0], -1))
    return preds, _as_index(target.reshape(target.shape[0], -1))


def _multiclass_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-class (C,) [global] or per-sample-per-class (N, C) [samplewise] int64 counts."""
    if top_k == 1 and multidim_average == "global":
        cm = confusion_matrix_update(preds, target, num_classes, ignore_index=ignore_index, dtype=CountType)
        tp = torch.diagonal(cm)
        fp = cm.sum(dim=0) - tp
        fn = cm.sum(dim=1) - tp
        tn = cm.sum() - tp - fp - fn
        return tp, fp, tn, fn

    keep = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    target_safe = torch.where(keep, target, 0)
    w = keep.to(CountType)
    if top_k > 1:
        pred_mask = select_topk(preds, top_k, dim=1).to(CountType)  # (N, C, S)
        oh_t = _one_hot(target_safe, num_classes, dim=1)  # (N, C, S)
        wc = w[:, None, :]
        dims = (2,) if multidim_average == "samplewise" else (0, 2)
        tp = torch.sum(pred_mask * oh_t * wc, dim=dims)
        fp = torch.sum(pred_mask * (1 - oh_t) * wc, dim=dims)
        fn = torch.sum((1 - pred_mask) * oh_t * wc, dim=dims)
        if multidim_average == "global":
            return tp, fp, w.sum() - tp - fp - fn, fn
        return tp, fp, w.sum(dim=1)[:, None] - tp - fp - fn, fn

    # samplewise: per-sample one-hot sums over the flattened extra dim
    oh_p = _one_hot(preds, num_classes, dim=-1)  # (N, S, C)
    oh_t = _one_hot(target_safe, num_classes, dim=-1)
    wc = w[..., None]
    tp = torch.sum(oh_p * oh_t * wc, dim=1)
    fp = torch.sum(oh_p * (1 - oh_t) * wc, dim=1)
    fn = torch.sum((1 - oh_p) * oh_t * wc, dim=1)
    tn = w.sum(dim=1)[:, None] - tp - fp - fn
    return tp, fp, tn, fn


def _multiclass_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
) -> Tensor:
    """Apply micro averaging and pack [tp, fp, tn, fn, support]; macro/weighted keep per-class counts."""
    res = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    if average == "micro":
        res = res.sum(dim=-2)
    return res


def multiclass_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """tp/fp/tn/fn/support for multiclass tasks (reference ``stat_scores.py:451``), int64."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index, top_k)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    tp, fp, tn, fn = _multiclass_stat_scores_update(preds, target, num_classes, top_k, multidim_average, ignore_index)
    return _multiclass_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)
