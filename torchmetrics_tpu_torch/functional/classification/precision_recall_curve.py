"""Precision-recall curves, the foundation of the curve family (ROC, AUROC, average precision).

Counterpart of ``torchmetrics_tpu/functional/classification/precision_recall_curve.py``, with the
same decomposition per task (arg validation → tensor validation → format → update → compute) and
the same two state regimes:

- **binned** (``thresholds`` an int, list or tensor): a ``(T, ..., 2, 2)`` confusion tensor of
  per-threshold counts. Every task counts through one launch of kernel K3's binned entry
  (:func:`torchmetrics_tpu_torch.ops.curve_counts.binned_confmat`), which reads the formatted
  scores and the raw target in place and drops ``ignore_index`` itself; ``average="micro"`` adds
  the per-class counts over the classes;
- **exact** (``thresholds=None``): the formatted scores, finished on the host in float64 numpy
  with sklearn's semantics, as in the JAX package; the tensors move to the CPU once per compute.

The JAX package's CPU lowering of the counts (``_uniform_hist_counts``) and its choice between two
lowerings (``set_curve_backend``) have no counterpart here: the kernel is the one lowering.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops.curve_counts import binned_confmat
from torchmetrics_tpu_torch.utils.checks import _check_binary_target, _check_same_shape
from torchmetrics_tpu_torch.utils.compute import _safe_divide, normalize_logits_if_needed
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Thresholds = Union[int, List[float], Tensor, np.ndarray, None]
ExactState = Tuple[Tensor, Tensor, Tensor]


def _as_tensor(x) -> Tensor:
    return x if isinstance(x, Tensor) else torch.as_tensor(np.asarray(x))


# ----------------------------------------------------------------- shared bits
def _adjust_threshold_arg(thresholds: Thresholds = None, device: Union[str, torch.device, None] = None) -> Optional[Tensor]:
    """The ``thresholds`` argument as a sorted float32 tensor on ``device``, or None (exact mode).

    An int builds the grid in numpy exactly as the JAX package does (``np.linspace`` in float32):
    ``torch.linspace`` may differ by an ulp, and a score on a threshold would then move a count.
    """
    if thresholds is None:
        return None
    if isinstance(thresholds, int):
        grid = np.linspace(0.0, 1.0, thresholds, dtype=np.float32)
    elif isinstance(thresholds, (list, tuple)):
        grid = np.sort(np.asarray(thresholds, np.float32))
    elif isinstance(thresholds, Tensor):
        return torch.sort(thresholds.to(device=device, dtype=torch.float32).reshape(-1)).values
    else:
        grid = np.sort(np.asarray(thresholds, np.float32).reshape(-1))
    return torch.from_numpy(grid).to(device)


def _validate_thresholds_arg(thresholds: Thresholds) -> None:
    if thresholds is not None and not isinstance(thresholds, (int, list, tuple, Tensor, np.ndarray)):
        raise ValueError(
            "Expected argument `thresholds` to either be an integer, list of floats or"
            f" tensor of floats, but got {thresholds}"
        )
    if isinstance(thresholds, int) and thresholds < 2:
        raise ValueError(
            f"If argument `thresholds` is an integer, expected it to be larger than 1, but got {thresholds}"
        )
    if isinstance(thresholds, (list, tuple)) and not all(isinstance(t, float) and 0 <= t <= 1 for t in thresholds):
        raise ValueError(
            f"If argument `thresholds` is a list, expected all elements to be floats in the [0,1] range,"
            f" but got {thresholds}"
        )


def _binned_update(
    preds: Tensor, target: Tensor, thresholds: Tensor, kind: str, num_classes: int = 1,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """One launch of K3's binned entry on the formatted scores and the raw target; a target of a
    type the kernel does not read is widened to int64 first (a truncating cast for floats, as the
    JAX package's ``astype(int32)``)."""
    if target.dtype not in (torch.int32, torch.int64, torch.uint8, torch.bool):
        target = target.to(torch.int64)
    return binned_confmat(
        preds.to(torch.float32).contiguous(), target.contiguous(),
        thresholds.to(device=preds.device, dtype=torch.float32), kind, num_classes, ignore_index,
    )


def _counts_to_confmat(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Tensor:
    """Pack per-threshold counts as ``(..., T, 2, 2)`` with layout ``[t, target, pred]``."""
    row0 = torch.stack([tn, fp], dim=-1)
    row1 = torch.stack([fn, tp], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _binary_clf_curve_exact(
    preds: np.ndarray, target: np.ndarray, weight: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """fps/tps/thresholds at each distinct score, descending (sklearn semantics; host path,
    ``precision_recall_curve.py:244``)."""
    preds = np.asarray(preds, np.float64)
    target = np.asarray(target, np.float64)
    if weight is not None:
        weight = np.asarray(weight, np.float64)
        keep = weight > 0
        preds, target, weight = preds[keep], target[keep], weight[keep]
    else:
        weight = np.ones_like(preds)
    desc = np.argsort(-preds, kind="stable")
    preds, target, weight = preds[desc], target[desc], weight[desc]
    distinct = np.where(np.diff(preds))[0]
    threshold_idxs = np.r_[distinct, preds.size - 1]
    tps = np.cumsum(target * weight)[threshold_idxs]
    fps = np.cumsum((1 - target) * weight)[threshold_idxs]
    return fps, tps, preds[threshold_idxs]


def _host(state: ExactState) -> Tuple[np.ndarray, np.ndarray, np.ndarray, torch.device]:
    """The exact-mode state on the host, moved once, and the device the result goes back to."""
    preds, target, weight = state
    device = preds.device if isinstance(preds, Tensor) else torch.device("cpu")
    return (*(x.cpu().numpy() if isinstance(x, Tensor) else np.asarray(x) for x in state), device)


def _f32(x: np.ndarray, device: torch.device) -> Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _precision_recall_from_exact(
    fps: np.ndarray, tps: np.ndarray, thresholds: np.ndarray, device: torch.device
) -> Tuple[Tensor, Tensor, Tensor]:
    precision = tps / np.maximum(tps + fps, 1e-38)
    recall = tps / tps[-1] if tps[-1] > 0 else np.ones_like(tps)
    precision = np.hstack([precision[::-1], 1.0])
    recall = np.hstack([recall[::-1], 0.0])
    return _f32(precision, device), _f32(recall, device), _f32(thresholds[::-1], device)


def _precision_recall_from_confmat(confmat: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """``(..., T, 2, 2)`` confusion state → precision/recall curves of length T+1 (binned mode)."""
    tps = confmat[..., 1, 1]
    fps = confmat[..., 0, 1]
    fns = confmat[..., 1, 0]
    precision = _safe_divide(tps, tps + fps)
    recall = _safe_divide(tps, tps + fns)
    return (
        torch.cat([precision, torch.ones_like(precision[..., :1])], dim=-1),
        torch.cat([recall, torch.zeros_like(recall[..., :1])], dim=-1),
        thresholds.to(confmat.device),
    )


def _is_binned(state: Union[Tensor, ExactState], thresholds: Optional[Tensor]) -> bool:
    return thresholds is not None and isinstance(state, Tensor)


# --------------------------------------------------------------------- binary
def _binary_precision_recall_curve_arg_validation(
    thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    _validate_thresholds_arg(thresholds)
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Argument `ignore_index` must be either `None` or an integer, but got {ignore_index}")


def _binary_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if not preds.is_floating_point():
        raise ValueError(f"Expected argument `preds` to be an floating tensor, but got {preds.dtype}")
    _check_binary_target(target, ignore_index)


def _exact_state(preds: Tensor, target: Tensor, ignore_index: Optional[int]) -> ExactState:
    """Exact mode's ``(preds, target, weight)``: ignored entries get target 0 and float32 weight 0,
    the others weight 1 (the JAX package's ``_format`` output)."""
    if ignore_index is None:
        return preds, target.to(torch.int32), torch.ones(target.shape, dtype=torch.float32, device=target.device)
    ignored = target == ignore_index
    return preds, torch.where(ignored, torch.zeros_like(target), target).to(torch.int32), (~ignored).to(torch.float32)


def _binary_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Flatten, sigmoid-if-logits; return ``(preds, target, thresholds)``. The target keeps its
    ``ignore_index`` entries: the binned update drops them in the kernel, exact mode through
    :func:`_exact_state`."""
    preds = normalize_logits_if_needed(preds.reshape(-1), "sigmoid")
    return preds, target.reshape(-1), _adjust_threshold_arg(thresholds, preds.device)


def _binary_precision_recall_curve_update(
    preds: Tensor, target: Tensor, thresholds: Tensor, ignore_index: Optional[int] = None
) -> Tensor:
    """Binned-state contribution: ``(T, 2, 2)`` confusion counts (exact mode has no tensor update)."""
    return _binned_update(preds, target, thresholds, "binary", ignore_index=ignore_index)


def _binary_precision_recall_curve_compute(
    state: Union[Tensor, ExactState], thresholds: Optional[Tensor]
) -> Tuple[Tensor, Tensor, Tensor]:
    """state = ``(T, 2, 2)`` confmat [binned] or ``(preds, target, weight)`` [exact]."""
    if _is_binned(state, thresholds):
        return _precision_recall_from_confmat(state, thresholds)
    preds, target, weight, device = _host(state)
    fps, tps, thr = _binary_clf_curve_exact(preds, target, weight)
    return _precision_recall_from_exact(fps, tps, thr, device)


def binary_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision-recall pairs at decision thresholds (reference ``precision_recall_curve.py:270``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds)
    if thresholds is None:
        return _binary_precision_recall_curve_compute(_exact_state(preds, target, ignore_index), None)
    state = _binary_precision_recall_curve_update(preds, target, thresholds, ignore_index)
    return _binary_precision_recall_curve_compute(state, thresholds)


# ------------------------------------------------------------------ multiclass
def _multiclass_precision_recall_curve_arg_validation(
    num_classes: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    average: Optional[str] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Argument `num_classes` must be an integer larger than 1, but got {num_classes}")
    if average not in (None, "micro", "macro"):
        raise ValueError(f"Expected argument `average` to be one of None, 'micro' or 'macro', but got {average}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multiclass_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int] = None
) -> None:
    if preds.ndim != target.ndim + 1:
        raise ValueError("Expected `preds` to have one more dimension than `target`")
    if not preds.is_floating_point():
        raise ValueError(f"`preds` must be a float tensor, but got {preds.dtype}")
    if preds.shape[1] != num_classes:
        raise ValueError(f"Expected `preds.shape[1]={preds.shape[1]}` to be equal to the number of classes")
    if preds.shape[0] != target.shape[0] or preds.shape[2:] != target.shape[1:]:
        raise ValueError("Expected the shape of `preds` should be (N, C, ...) and the shape of `target` (N, ...).")
    t = target if ignore_index is None else target[target != ignore_index]
    if t.numel():
        lo, hi = torch.stack(torch.aminmax(t)).tolist()
        if lo < 0 or hi >= num_classes:
            raise RuntimeError(f"Detected values in `target` outside [0, {num_classes})")


def _multiclass_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """→ ``(scores (N, C), target (N,), thresholds)``; the target keeps its ``ignore_index`` entries."""
    preds = torch.movedim(preds, 1, -1).reshape(-1, num_classes)
    preds = normalize_logits_if_needed(preds, "softmax")
    return preds, target.reshape(-1), _adjust_threshold_arg(thresholds, preds.device)


def _micro_exact_state(preds: Tensor, target: Tensor, num_classes: int, ignore_index: Optional[int]) -> ExactState:
    """Exact mode's micro state: every (sample, class) pair becomes a binary decision (one-vs-rest
    flattening, as the JAX package's micro ``_format`` does)."""
    preds, target, weight = _exact_state(preds, target, ignore_index)
    onehot = _one_vs_rest(target, num_classes).to(torch.int32)
    return preds.reshape(-1), onehot.reshape(-1), torch.repeat_interleave(weight, num_classes)


def _one_vs_rest(target: Tensor, num_classes: int) -> Tensor:
    return (target[:, None] == torch.arange(num_classes, device=target.device)[None, :]).to(torch.float32)


def _multiclass_precision_recall_curve_update(
    preds: Tensor, target: Tensor, num_classes: int, thresholds: Tensor, ignore_index: Optional[int] = None,
    average: Optional[str] = None,
) -> Tensor:
    """``(T, C, 2, 2)`` one-vs-rest confusion counts (``precision_recall_curve.py:448``), or with
    ``average="micro"`` their ``(T, 2, 2)`` sum over the classes, which equals the binary counts of
    the one-vs-rest flattening exactly."""
    confmat = _binned_update(preds, target, thresholds, "multiclass", num_classes, ignore_index)
    return confmat.sum(dim=1) if average == "micro" else confmat


def _exact_curves(state: ExactState, num_rows: int, positives, curve) -> Tuple[List[Tensor], List[Tensor], List[Tensor]]:
    """Per-class exact curves: the state moves to the host once, then ``curve(preds, target,
    weight, device)`` runs on each row with ``positives(target, weight, row)``."""
    preds, target, weight, device = _host(state)
    out: Tuple[List[Tensor], List[Tensor], List[Tensor]] = ([], [], [])
    for row in range(num_rows):
        t, w = positives(target, weight, row)
        for acc, value in zip(out, curve(preds[:, row], t, w, device)):
            acc.append(value)
    return out


def _pr_exact(preds, target, weight, device):
    return _precision_recall_from_exact(*_binary_clf_curve_exact(preds, target, weight), device)


def _class_positives(target, weight, c):
    return (target == c).astype(np.float64), weight


def _label_positives(target, weight, lbl):
    return target[:, lbl], weight[:, lbl]


def _multiclass_precision_recall_curve_compute(
    state: Union[Tensor, ExactState],
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
):
    if average == "micro":
        return _binary_precision_recall_curve_compute(state, thresholds)
    if _is_binned(state, thresholds):
        return _precision_recall_from_confmat(torch.movedim(state, 0, 1), thresholds)  # (C, T, 2, 2)
    return _exact_curves(state, num_classes, _class_positives, _pr_exact)


def multiclass_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Thresholds = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """One-vs-rest PR curves (reference ``precision_recall_curve.py:510``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, thresholds = _multiclass_precision_recall_curve_format(preds, target, num_classes, thresholds)
    if thresholds is None:
        state = (_micro_exact_state(preds, target, num_classes, ignore_index) if average == "micro"
                 else _exact_state(preds, target, ignore_index))
        return _multiclass_precision_recall_curve_compute(state, num_classes, None, average)
    state = _multiclass_precision_recall_curve_update(preds, target, num_classes, thresholds, ignore_index, average)
    return _multiclass_precision_recall_curve_compute(state, num_classes, thresholds, average)


# ------------------------------------------------------------------ multilabel
def _multilabel_precision_recall_curve_arg_validation(
    num_labels: int, thresholds: Thresholds = None, ignore_index: Optional[int] = None
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Argument `num_labels` must be an integer larger than 1, but got {num_labels}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multilabel_precision_recall_curve_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _check_same_shape(preds, target)
    if not preds.is_floating_point():
        raise ValueError(f"`preds` must be a float tensor, but got {preds.dtype}")
    if preds.shape[1] != num_labels:
        raise ValueError(f"Expected `preds.shape[1]={preds.shape[1]}` to be equal to the number of labels {num_labels}")
    _check_binary_target(target, ignore_index)


def _multilabel_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """→ ``(scores (N, L), target (N, L), thresholds)``; extra dims join N, and the target keeps
    its ``ignore_index`` entries."""
    preds = torch.movedim(preds.reshape(preds.shape[0], num_labels, -1), 1, -1).reshape(-1, num_labels)
    target = torch.movedim(target.reshape(target.shape[0], num_labels, -1), 1, -1).reshape(-1, num_labels)
    preds = normalize_logits_if_needed(preds, "sigmoid")
    return preds, target, _adjust_threshold_arg(thresholds, preds.device)


def _multilabel_precision_recall_curve_update(
    preds: Tensor, target: Tensor, num_labels: int, thresholds: Tensor, ignore_index: Optional[int] = None
) -> Tensor:
    """``(T, L, 2, 2)`` per-label confusion counts (``precision_recall_curve.py:566``)."""
    return _binned_update(preds, target, thresholds, "multilabel", num_labels, ignore_index)


def _multilabel_precision_recall_curve_compute(
    state: Union[Tensor, ExactState],
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
):
    if _is_binned(state, thresholds):
        return _precision_recall_from_confmat(torch.movedim(state, 0, 1), thresholds)  # (L, T, 2, 2)
    return _exact_curves(state, num_labels, _label_positives, _pr_exact)


def multilabel_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Thresholds = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Per-label PR curves (reference ``precision_recall_curve.py:728``)."""
    preds, target = _as_tensor(preds), _as_tensor(target)
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, thresholds = _multilabel_precision_recall_curve_format(preds, target, num_labels, thresholds)
    if thresholds is None:
        return _multilabel_precision_recall_curve_compute(_exact_state(preds, target, ignore_index), num_labels, None,
                                                          ignore_index)
    state = _multilabel_precision_recall_curve_update(preds, target, num_labels, thresholds, ignore_index)
    return _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)


def _dispatch(task: str, num_classes: Optional[int], num_labels: Optional[int]) -> ClassificationTask:
    """The task, with the class or label count it needs checked (the task entries' shared head)."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.MULTICLASS and not isinstance(num_classes, int):
        raise ValueError(f"`num_classes` must be `int` but `{type(num_classes)} was passed.`")
    if task == ClassificationTask.MULTILABEL and not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` must be `int` but `{type(num_labels)} was passed.`")
    return task


def precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Thresholds = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatching entry (reference ``precision_recall_curve.py:947``)."""
    task = _dispatch(task, num_classes, num_labels)
    if task == ClassificationTask.BINARY:
        return binary_precision_recall_curve(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_precision_recall_curve(preds, target, num_classes, thresholds, average, ignore_index, validate_args)
    return multilabel_precision_recall_curve(preds, target, num_labels, thresholds, ignore_index, validate_args)
