"""Group fairness (counterpart of ``torchmetrics_tpu/functional/classification/group_fairness.py``).

The per-group tp/fp/tn/fn counts are one K1 bincount over the fused index
``4 * group + 2 * target + pred`` of length ``4 * num_groups`` (``stat_scores._binary_counts``,
shared with the multilabel counts): an ignored entry, or one whose target or pred is not 0/1,
gets an index out of range and counts nowhere. The JAX package counts with four float-weighted
bincounts (``:53-56``), which here would be four K2 launches. The ``(num_groups, 2, 2)`` result
is reordered into JAX's ``[tp, fp, tn, fn]`` float32 ``(num_groups, 4)`` state (exact: int64 in
the kernel, and exact in float32 below 2^24 per bin, JAX's own limit).

Host reads, as in the JAX package: the result keys of the parity ratios come from the
``argmin``/``argmax`` of the state (``:87-88, :96-97``; one read for both, first index on ties
as ``jnp`` gives), and ``demographic_parity``, ``equal_opportunity`` and ``binary_fairness``
read ``max(groups)`` (``:111, :132, :161``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _as_tensor,
    _binary_counts,
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _unpack,
    _value_range,
)
from torchmetrics_tpu_torch.utils.checks import _is_integer
from torchmetrics_tpu_torch.utils.compute import _safe_divide


def _groups_validation(groups: Tensor, num_groups: int) -> None:
    if groups.numel():
        lo, hi = _value_range(groups)
        if lo < 0 or hi >= num_groups:
            raise ValueError(
                f"Expected all values in `groups` to be in the range [0, {num_groups}) but got values"
                f" in range [{lo}, {hi}]"
            )
    if not _is_integer(groups):
        raise ValueError(f"Expected dtype of argument `groups` to be int, but got {groups.dtype}.")


def _binary_groups_stat_scores_update(
    preds: Tensor, target: Tensor, groups: Tensor, num_groups: int, threshold: float = 0.5,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """``(num_groups, 4)`` float32 ``[tp, fp, tn, fn]``, one K1 launch on the card."""
    preds, target = _binary_stat_scores_format(preds, target, threshold)
    groups = groups.reshape(preds.shape).to(torch.int64)
    tp, fp, tn, fn = _unpack(_binary_counts(preds, target, groups, num_groups, ignore_index))
    return torch.stack([tp, fp, tn, fn], dim=-1).to(torch.float32)


def _group_rates(stats: Tensor, num_groups: int) -> Dict[str, Tensor]:
    return {f"group_{g}": _safe_divide(stats[g], torch.sum(stats[g])) for g in range(num_groups)}


def binary_groups_stat_rates(
    preds: Tensor, target: Tensor, groups: Tensor, num_groups: int, threshold: float = 0.5,
    ignore_index: Optional[int] = None, validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Per-group [tp, fp, tn, fn] rates (reference ``group_fairness.py:105``)."""
    preds, target, groups = _as_tensor(preds), _as_tensor(target), _as_tensor(groups)
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)
        _groups_validation(groups, num_groups)
    stats = _binary_groups_stat_scores_update(preds, target, groups, num_groups, threshold, ignore_index)
    return _group_rates(stats, num_groups)


def _ratio_of_extremes(rates: Tensor, prefix: str) -> Dict[str, Tensor]:
    """``{f"{prefix}_{lo}_{hi}": rates[lo] / rates[hi]}`` for the groups of the lowest and the
    highest rate, the first of each on ties; one read of the device."""
    lo, hi = torch.stack([torch.argmin(rates), torch.argmax(rates)]).tolist()
    return {f"{prefix}_{lo}_{hi}": _safe_divide(rates[lo], rates[hi])}


def _compute_binary_demographic_parity(stats: Tensor) -> Dict[str, Tensor]:
    """min/max positive-prediction-rate ratio (reference ``group_fairness.py:164``)."""
    tp, fp, tn, fn = stats.unbind(-1)
    return _ratio_of_extremes(_safe_divide(tp + fp, tp + fp + tn + fn), "DP")


def _compute_binary_equal_opportunity(stats: Tensor) -> Dict[str, Tensor]:
    """min/max true-positive-rate ratio (reference ``group_fairness.py:243``)."""
    tp, fp, tn, fn = stats.unbind(-1)
    return _ratio_of_extremes(_safe_divide(tp, tp + fn), "EO")


def _num_groups(groups: Tensor) -> int:
    return int(groups.max()) + 1


def demographic_parity(preds: Tensor, groups: Tensor, threshold: float = 0.5, ignore_index: Optional[int] = None,
                       validate_args: bool = True) -> Dict[str, Tensor]:
    """Demographic-parity ratio (reference ``group_fairness.py:177``)."""
    preds, groups = _as_tensor(preds), _as_tensor(groups)
    num_groups = _num_groups(groups)
    target = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        _groups_validation(groups, num_groups)
    stats = _binary_groups_stat_scores_update(preds, target, groups, num_groups, threshold, ignore_index)
    return _compute_binary_demographic_parity(stats)


def equal_opportunity(preds: Tensor, target: Tensor, groups: Tensor, threshold: float = 0.5,
                      ignore_index: Optional[int] = None, validate_args: bool = True) -> Dict[str, Tensor]:
    """Equal-opportunity ratio (reference ``group_fairness.py:258``)."""
    preds, target, groups = _as_tensor(preds), _as_tensor(target), _as_tensor(groups)
    num_groups = _num_groups(groups)
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)
        _groups_validation(groups, num_groups)
    stats = _binary_groups_stat_scores_update(preds, target, groups, num_groups, threshold, ignore_index)
    return _compute_binary_equal_opportunity(stats)


def binary_fairness(preds: Tensor, target: Tensor, groups: Tensor, task: str = "all", threshold: float = 0.5,
                    ignore_index: Optional[int] = None, validate_args: bool = True) -> Dict[str, Tensor]:
    """Demographic parity and/or equal opportunity (reference ``group_fairness.py:326``)."""
    if task not in ("demographic_parity", "equal_opportunity", "all"):
        raise ValueError(
            f"Expected argument `task` to either be ``demographic_parity``,"
            f"``equal_opportunity`` or ``all`` but got {task}."
        )
    preds, groups = _as_tensor(preds), _as_tensor(groups)
    if task == "demographic_parity":
        target = torch.zeros(preds.shape, dtype=torch.int32, device=preds.device)
    target = _as_tensor(target)
    num_groups = _num_groups(groups)
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        if task != "demographic_parity":
            _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)
        _groups_validation(groups, num_groups)
    stats = _binary_groups_stat_scores_update(preds, target, groups, num_groups, threshold, ignore_index)
    out: Dict[str, Tensor] = {}
    if task in ("demographic_parity", "all"):
        out.update(_compute_binary_demographic_parity(stats))
    if task in ("equal_opportunity", "all"):
        out.update(_compute_binary_equal_opportunity(stats))
    return out
