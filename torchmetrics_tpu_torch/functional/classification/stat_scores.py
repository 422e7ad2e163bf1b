"""Stat scores (tp/fp/tn/fn), the foundation of the classification stack.

Counterpart of ``torchmetrics_tpu/functional/classification/stat_scores.py`` (binary ``:38-159``,
multiclass ``:163-350``, multilabel ``:354-472``, the task entry ``:475-514``) with the reference's
decomposition ``_arg_validation`` → ``_tensor_validation`` → ``_format`` → ``_update`` →
``_compute``.

The counts run through kernel K1 on a CUDA tensor, in one launch per update:

- multiclass, global ``top_k == 1``: one confusion-matrix count over ``target * C + pred``;
- binary, global: the same count at C = 2 (tp = ``cm[1, 1]``, fp = ``cm[0, 1]``, fn = ``cm[1, 0]``,
  tn = ``cm[0, 0]``);
- multilabel, and binary ``samplewise``: one bincount over the fused index
  ``4 * row + 2 * target + pred``, where a row is a label, a sample, or both.

``ignore_index`` is applied inside the count: the ``_format`` functions return the raw target.
Counts are int64 (the JAX package carries float32 counts and returns int32; the values are
equal). Validation runs on the host and reads the device once per batch. Multiclass
``samplewise`` and ``top_k > 1`` stay one-hot sums, as in JAX.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops.histogram import bincount, confusion_matrix_update
from torchmetrics_tpu_torch.utils.checks import _check_binary_target, _check_same_shape
from torchmetrics_tpu_torch.utils.compute import normalize_logits_if_needed
from torchmetrics_tpu_torch.utils.data import select_topk
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

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


def _binary_counts(preds: Tensor, target: Tensor, rows: Tensor, num_rows: int, ignore_index: Optional[int]) -> Tensor:
    """``(num_rows, 2, 2)`` int64 counts laid out ``[row, target, pred]``: one bincount over the
    fused index ``4 * row + 2 * target + pred``. ``rows`` broadcasts against ``preds``; an entry
    whose target is ``ignore_index`` or not 0/1, or whose pred is not 0/1, gets an index out of
    range and counts nowhere. Above K1's shared bins (a ``samplewise`` count over many rows) the
    kernel takes its global branch."""
    keep = ((target == 0) | (target == 1)) & ((preds == 0) | (preds == 1))
    if ignore_index is not None:
        keep &= target != ignore_index
    fused = torch.where(keep, rows * 4 + target.to(torch.int64) * 2 + preds, -1)
    return bincount(fused, num_rows * 4, CountType).reshape(num_rows, 2, 2)


def _unpack(cm: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """tp, fp, tn, fn of ``[..., target, pred]`` counts."""
    return cm[..., 1, 1], cm[..., 0, 1], cm[..., 0, 0], cm[..., 1, 0]


# --------------------------------------------------------------------- binary
def _binary_stat_scores_arg_validation(
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Argument `threshold` must be a float in the [0,1] range, but got {threshold}.")
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ['global', 'samplewise'], but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Argument `ignore_index` must be either `None` or an integer, but got {ignore_index}")


def _binary_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    _check_same_shape(preds, target)
    if multidim_average != "global" and preds.ndim < 2:
        raise ValueError("Inputs must be at least 2D when multidim_average is set to `samplewise`")
    _check_binary_target(target, ignore_index, None if preds.is_floating_point() else preds)


def _binary_labels(preds: Tensor, threshold: float) -> Tensor:
    """0/1 labels: float scores through sigmoid-if-logits and ``> threshold``; integer preds as they are."""
    if preds.is_floating_point():
        return (normalize_logits_if_needed(preds, "sigmoid") > threshold).to(torch.int32)
    return _as_index(preds)


def _binary_stat_scores_format(preds: Tensor, target: Tensor, threshold: float = 0.5) -> Tuple[Tensor, Tensor]:
    """→ ``(preds01, target)``, both ``(N, S)``; the target keeps its ``ignore_index`` entries."""
    n = target.shape[0] if target.ndim else 1
    return _binary_labels(preds, threshold).reshape(n, -1), _as_index(target.reshape(n, -1))


def _binary_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Scalar [global] or (N,) [samplewise] int64 counts, one K1 launch."""
    if multidim_average == "global":
        cm = confusion_matrix_update(preds, target, 2, ignore_index=ignore_index, dtype=CountType)
    else:
        rows = torch.arange(target.shape[0], device=target.device)[:, None]
        cm = _binary_counts(preds, target, rows, target.shape[0], ignore_index)
    return _unpack(cm)


def _binary_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, multidim_average: str = "global"
) -> Tensor:
    """Pack [tp, fp, tn, fn, support] (reference ``stat_scores.py:134``)."""
    return torch.stack([tp, fp, tn, fn, tp + fn], dim=0 if tp.ndim == 0 else -1)


def binary_stat_scores(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """tp/fp/tn/fn/support for binary tasks (reference ``stat_scores.py:156``), int64."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target = _binary_stat_scores_format(preds, target, threshold)
    tp, fp, tn, fn = _binary_stat_scores_update(preds, target, multidim_average, ignore_index)
    return _binary_stat_scores_compute(tp, fp, tn, fn, multidim_average)


# ------------------------------------------------------------------ multiclass
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


# ------------------------------------------------------------------ multilabel
def _multilabel_stat_scores_arg_validation(
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Argument `num_labels` must be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Argument `threshold` must be a float, but got {threshold}.")
    allowed_average = ("micro", "macro", "weighted", "none", None)
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average}, but got {average}")
    if multidim_average not in ("global", "samplewise"):
        raise ValueError(
            f"Expected argument `multidim_average` to be one of ['global', 'samplewise'], but got {multidim_average}"
        )
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Argument `ignore_index` must be either `None` or an integer, but got {ignore_index}")


def _multilabel_stat_scores_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> None:
    _check_same_shape(preds, target)
    if preds.shape[1] != num_labels:
        raise ValueError(
            f"Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels"
            f" but got {preds.shape[1]} and expected {num_labels}"
        )
    if multidim_average != "global" and preds.ndim < 3:
        raise ValueError("Inputs must be at least 3D when multidim_average is set to `samplewise`")
    _check_binary_target(target, ignore_index)


def _multilabel_stat_scores_format(
    preds: Tensor, target: Tensor, num_labels: int, threshold: float = 0.5
) -> Tuple[Tensor, Tensor]:
    """→ ``(preds01, target)``, both ``(N, L, S)``: extra dims flattened, the target raw."""
    preds = _binary_labels(preds, threshold)
    return preds.reshape(preds.shape[0], num_labels, -1), _as_index(target.reshape(target.shape[0], num_labels, -1))


def _multilabel_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-label int64 counts, (L,) [global] or (N, L) [samplewise], one K1 launch."""
    n, num_labels = target.shape[0], target.shape[1]
    labels = torch.arange(num_labels, device=target.device)[None, :, None]
    if multidim_average == "global":
        return _unpack(_binary_counts(preds, target, labels, num_labels, ignore_index))
    rows = torch.arange(n, device=target.device)[:, None, None] * num_labels + labels
    return _unpack(_binary_counts(preds, target, rows, n * num_labels, ignore_index).reshape(n, num_labels, 2, 2))


def _multilabel_stat_scores_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
) -> Tensor:
    return _multiclass_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


def multilabel_stat_scores(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """tp/fp/tn/fn/support for multilabel tasks (reference ``stat_scores.py:742``), int64."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target = _multilabel_stat_scores_format(preds, target, num_labels, threshold)
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, multidim_average, ignore_index)
    return _multilabel_stat_scores_compute(tp, fp, tn, fn, average, multidim_average)


def _check_task(task: str, num_classes: Optional[int], num_labels: Optional[int], top_k: Optional[int] = 1) -> ClassificationTask:
    """The task, with the class or label count and ``top_k`` it needs checked (the stat-score task
    entries' shared head)."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` must be `int` but `{type(num_classes)} was passed.`")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
    if task == ClassificationTask.MULTILABEL and not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` must be `int` but `{type(num_labels)} was passed.`")
    return task


def stat_scores(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching entry (reference ``stat_scores.py:1040``)."""
    task = _check_task(task, num_classes, num_labels, top_k)
    if task == ClassificationTask.BINARY:
        return binary_stat_scores(preds, target, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_stat_scores(
            preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args
        )
    return multilabel_stat_scores(
        preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args
    )
