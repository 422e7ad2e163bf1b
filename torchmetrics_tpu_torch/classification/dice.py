"""Dice (counterpart of ``torchmetrics_tpu/classification/dice.py``, ``Dice:16``).

The states keep the JAX package's dtypes, so :func:`torchmetrics_tpu_torch.interop.load_numpy_state`
carries them across unchanged: float32 ``tp``/``fp``/``fn`` sums of one entry per kept class
(``:78-80``), or ``cat`` list states of per-sample counts when ``average="samples"`` or
``mdmc_average="samplewise"`` (``:73-75``). The ``multiclass=False`` value checks read the
device; they run in ``_validate``, before the step, so the update itself can be captured.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.classification.dice import (
    _check_binary_for_multiclass_false,
    _dice_from_counts,
    _dice_update,
    _to_binary_for_multiclass_false,
)
from torchmetrics_tpu_torch.metric import Metric


class Dice(Metric):
    """Dice score = 2·tp / (2·tp + fp + fn) (reference ``dice.py:31``).

    ``average`` is micro, macro, none or samples; ``ignore_index`` drops that class's statistics
    (legacy semantics). ``num_classes`` is needed for multiclass scores unless the class axis has
    the state's width.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import Dice
        >>> metric = Dice(device="cpu")
        >>> metric.update(torch.tensor([0.1, 0.4, 0.35, 0.8]), torch.tensor([0, 0, 1, 1]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.7500
    """
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    is_differentiable = False
    higher_is_better = True
    full_state_update = False

    def __init__(
        self,
        zero_division: float = 0.0,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = "global",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_average = ("micro", "macro", "samples", "none", None)
        if average not in allowed_average:
            raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
        if ignore_index is not None and num_classes is not None and not 0 <= ignore_index < num_classes:
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")
        self.zero_division = zero_division
        self.num_classes = num_classes
        self.threshold = threshold
        self.average = average
        self.mdmc_average = mdmc_average
        self.ignore_index = ignore_index
        self.top_k = top_k
        self.multiclass = multiclass
        if multiclass is False and ignore_index is not None:
            raise ValueError("You can not use `ignore_index` with binary data.")
        # per-sample counts: both `average="samples"` and `mdmc_average="samplewise"` reduce
        # within each sample before the mean over samples
        self._samplewise_state = average == "samples" or mdmc_average == "samplewise"
        for name in ("tp", "fp", "fn"):
            if self._samplewise_state:
                self.add_state(name, [], dist_reduce_fx="cat")
            else:
                self.add_state(name, torch.zeros(self._reduced_size(), dtype=torch.float32), dist_reduce_fx="sum")

    def _reduced_size(self) -> int:
        if self.num_classes is None:
            # the state's shape must be known before the first update: binary by default
            return 2 if self.ignore_index is None else 1
        return self.num_classes - (1 if self.ignore_index is not None else 0)

    def _validate(self, preds, target) -> None:
        if self.multiclass is False:
            _check_binary_for_multiclass_false(preds, target)

    def _update(self, state, preds, target):
        if self.multiclass is False:
            preds, target = _to_binary_for_multiclass_false(preds, target)
        if preds.ndim == target.ndim + 1 and preds.is_floating_point():
            n_cls = preds.shape[1]
            if self.num_classes is not None and n_cls != self.num_classes:
                raise ValueError(
                    f"`preds` has {n_cls} classes but metric was built with num_classes={self.num_classes}"
                )
            if self.num_classes is None and not self._samplewise_state and n_cls != self._reduced_size():
                raise ValueError(
                    f"Pass `num_classes={n_cls}` at construction for probabilistic multiclass `preds`"
                    " (the state's shape must be known up front)."
                )
            if (self.top_k or 1) == 1:
                preds = torch.argmax(preds, dim=1)  # top_k > 1 keeps the scores for the top-k path
        else:
            n_cls = self.num_classes or 2
        tp, fp, fn = _dice_update(preds, target, n_cls, self.threshold, self.top_k, self.ignore_index,
                                  samplewise=self._samplewise_state)
        if self._samplewise_state:
            return {"tp": tp, "fp": fp, "fn": fn}
        return {"tp": state["tp"] + tp, "fp": state["fp"] + fp, "fn": state["fn"] + fn}

    def _compute(self, state):
        tp, fp, fn = state["tp"], state["fp"], state["fn"]
        if self.multiclass is False:
            # only the positive-class statistics survive the legacy conversion
            tp, fp, fn = tp[..., 1:2], fp[..., 1:2], fn[..., 1:2]
        if self.mdmc_average == "samplewise" and self.average != "samples":
            # per-sample reduction first, then the mean over samples
            return torch.mean(_dice_from_counts(tp, fp, fn, self.average, self.zero_division), dim=0)
        return _dice_from_counts(tp, fp, fn, self.average, self.zero_division)
