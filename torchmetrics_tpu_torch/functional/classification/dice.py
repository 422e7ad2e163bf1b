"""Dice score (counterpart of ``torchmetrics_tpu/functional/classification/dice.py``).

Dice = 2·tp / (2·tp + fp + fn), F1 under another name: the reference's single legacy ``dice``
entry (binary or multiclass inputs found from their shapes and dtypes, ``average`` in
micro/macro/none/samples, ``mdmc_average`` in global/samplewise, ``ignore_index`` dropping a
CLASS from the statistics) over the multiclass stat-score counts (K1 on the card for a global
``top_k == 1`` count; one-hot sums for ``top_k > 1`` and ``samplewise``, as in JAX).

Two functions read the device from the host, and run only outside a captured step:
``_infer_num_classes`` (``:92-98``, the largest label when ``num_classes`` is not given) and
``_check_binary_for_multiclass_false`` (the value checks of ``_to_binary_for_multiclass_false``,
``:83, :87``). The module ``Dice`` runs the latter in its ``_validate``, before the step.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _as_tensor,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_update,
)
from torchmetrics_tpu_torch.utils.compute import _safe_divide, normalize_logits_if_needed


def _dice_from_counts(tp: Tensor, fp: Tensor, fn: Tensor, average: Optional[str], zero_division: float = 0.0) -> Tensor:
    tp, fp, fn = (x.to(torch.float32) for x in (tp, fp, fn))
    if average in ("micro", "samples"):
        # "samples": counts arrive as (N, C) samplewise; micro-reduce within each sample, then
        # mean over samples (reference average='samples' semantics)
        tp, fp, fn = torch.sum(tp, dim=-1), torch.sum(fp, dim=-1), torch.sum(fn, dim=-1)
    score = _safe_divide(2 * tp, 2 * tp + fp + fn, zero_division)
    if average == "macro":
        # classes absent from both preds and target are dropped from the mean (reference
        # _reduce_stat_scores ignores tp+fp+fn == 0 rows)
        present = (tp + fp + fn) > 0
        return _safe_divide(
            torch.sum(score.masked_fill(~present, 0.0), dim=-1),
            torch.sum(present, dim=-1).to(torch.float32),
            zero_division,
        )
    if average == "samples":
        return torch.mean(score)
    return score


def _drop_class(x: Tensor, index: Optional[int]) -> Tensor:
    """``x`` without class ``index`` of its last axis (slices only, so a captured step can hold it)."""
    if index is None or not 0 <= index < x.shape[-1]:
        return x
    return torch.cat([x[..., :index], x[..., index + 1:]], dim=-1)


def _dice_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    ignore_index: Optional[int] = None,
    samplewise: bool = False,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-class float32 (tp, fp, fn); ``ignore_index`` drops that class's statistics (legacy semantics)."""
    if preds.is_floating_point() and preds.ndim == target.ndim:
        # binary probabilities
        preds = (normalize_logits_if_needed(preds, "sigmoid") > threshold).to(torch.int32)
    preds_f, target_f = _multiclass_stat_scores_format(preds, target, top_k or 1)
    tp, fp, _, fn = _multiclass_stat_scores_update(
        preds_f, target_f, num_classes, top_k or 1, "samplewise" if samplewise else "global", None
    )
    return tuple(_drop_class(x, ignore_index).to(torch.float32) for x in (tp, fp, fn))


def _check_binary_for_multiclass_false(preds: Tensor, target: Tensor) -> None:
    """The legacy ``multiclass=False`` value checks (reference ``checks.py:440-450``): preds that
    are not 2-column scores, and the target, must not exceed 1 once truncated to an integer (the
    JAX package's ``int(jnp.max(x)) > 1``). One read of the device."""
    scores = preds.ndim == target.ndim + 1 and preds.is_floating_point()
    if scores and preds.shape[1] != 2:
        raise ValueError(
            "You have set `multiclass=False`, but have more than 2 classes in your data,"
            " based on the C dimension of `preds`."
        )
    highs = [target.max()] if scores else [preds.max(), target.max()]
    over = (torch.stack([h.to(torch.float64) for h in highs]).trunc() > 1).tolist()
    if not scores and over[0]:
        raise ValueError("If you set `multiclass=False` and `preds` are integers, then `preds` should not exceed 1.")
    if over[-1]:
        raise ValueError("If you set `multiclass=False`, then `target` should not exceed 1.")


def _to_binary_for_multiclass_false(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Legacy ``multiclass=False`` re-read (reference ``checks.py:440-450``): 2-column scores become
    the positive-class indicator; integer inputs are taken as they are (their checks are
    :func:`_check_binary_for_multiclass_false`, outside any captured step)."""
    if preds.ndim == target.ndim + 1 and preds.is_floating_point():
        preds = (torch.argmax(preds, dim=1) == 1).to(torch.int32)
    return preds, target


def _infer_num_classes(preds: Tensor, target: Tensor, num_classes: Optional[int]) -> int:
    if num_classes is not None:
        return num_classes
    if preds.ndim == target.ndim + 1:
        return preds.shape[1]
    m = int(torch.stack([preds.max(), target.max()]).max())
    return max(m + 1, 2)


def dice(
    preds: Tensor,
    target: Tensor,
    zero_division: float = 0.0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Dice score (reference ``dice.py:89``).

    ``multiclass`` is the legacy type-override flag (reference ``utilities/checks.py:440-450``):
    ``False`` re-reads 2-class data as binary (the positive-class column), ``True`` keeps the
    multiclass treatment, which the one-hot counts already give binary labels.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import dice
        >>> print(f"{float(dice(torch.tensor([0, 2, 1, 2]), torch.tensor([0, 1, 1, 2]))):.4f}")
        0.7500
    """
    allowed = ("micro", "macro", "samples", "none", None)
    if average not in allowed:
        raise ValueError(f"The `average` has to be one of {allowed}, got {average}.")
    if mdmc_average not in ("global", "samplewise", None):
        raise ValueError(f"The `mdmc_average` has to be 'global', 'samplewise' or None, got {mdmc_average}.")
    preds, target = _as_tensor(preds), _as_tensor(target)
    if multiclass is False:
        if ignore_index is not None:
            # the legacy formatter reduces the data to binary, where ignore_index is rejected
            raise ValueError("You can not use `ignore_index` with binary data.")
        _check_binary_for_multiclass_false(preds, target)
        preds, target = _to_binary_for_multiclass_false(preds, target)
    samplewise = average == "samples" or mdmc_average == "samplewise"
    if preds.ndim == target.ndim + 1 and preds.is_floating_point() and (top_k or 1) == 1:
        preds_fmt = torch.argmax(preds, dim=1)
    else:
        preds_fmt = preds  # top_k > 1 keeps the (N, C, ...) scores for the top-k path
    n_cls = _infer_num_classes(preds, target, num_classes)
    tp, fp, fn = _dice_update(preds_fmt, target, n_cls, threshold, top_k, ignore_index, samplewise)
    if multiclass is False:
        # the legacy formatter keeps only the positive-class column (checks.py:440-441)
        tp, fp, fn = tp[..., 1:2], fp[..., 1:2], fn[..., 1:2]
    if mdmc_average == "samplewise" and average != "samples":
        # per-sample reduction first, then mean over samples (reference mdmc semantics)
        return torch.mean(_dice_from_counts(tp, fp, fn, average, zero_division), dim=0)
    return _dice_from_counts(tp, fp, fn, average, zero_division)
