"""Module nominal association metrics (counterpart of ``torchmetrics_tpu/nominal/metrics.py``).

The four association classes keep one float32 ``(C, C)`` ``confmat`` state with
``dist_reduce_fx="sum"`` (``_ConfmatNominalMetric``, ``metrics.py:27``), counted by K1 with no read
of the device, so their ``forward`` is one captured graph per input signature on the card.
``FleissKappa`` keeps a ``cat`` list state of per-subject counts (``metrics.py:159``), which holds
its steps on the eager tier.
"""
from __future__ import annotations

from typing import Any, Dict, Literal, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.nominal.cramers import _cramers_v_compute, _cramers_v_update
from torchmetrics_tpu_torch.functional.nominal.fleiss_kappa import _fleiss_kappa_compute, _fleiss_kappa_update
from torchmetrics_tpu_torch.functional.nominal.pearson import (
    _pearsons_contingency_coefficient_compute,
    _pearsons_contingency_coefficient_update,
)
from torchmetrics_tpu_torch.functional.nominal.theils_u import _theils_u_compute, _theils_u_update
from torchmetrics_tpu_torch.functional.nominal.tschuprows import _tschuprows_t_compute, _tschuprows_t_update
from torchmetrics_tpu_torch.functional.nominal.utils import _nominal_input_validation
from torchmetrics_tpu_torch.metric import Metric


class _ConfmatNominalMetric(Metric):
    """Shared shell: the ``(C, C)`` float32 sum state and a compute that reads nothing back under capture."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        num_classes: int,
        nan_strategy: Literal["replace", "drop"] = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if not (isinstance(num_classes, int) and num_classes > 0):
            raise ValueError(f"Argument `num_classes` should be a positive integer, got {num_classes}.")
        _nominal_input_validation(nan_strategy, nan_replace_value)
        self.num_classes = num_classes
        self.nan_strategy = nan_strategy
        self.nan_replace_value = nan_replace_value
        self.add_state("confmat", torch.zeros((num_classes, num_classes), dtype=torch.float32), dist_reduce_fx="sum")

    def _update_fn(self, preds: Tensor, target: Tensor) -> Tensor:
        raise NotImplementedError

    def _update(self, state: Dict[str, Tensor], preds: Tensor, target: Tensor) -> Dict[str, Tensor]:
        return {"confmat": state["confmat"] + self._update_fn(preds, target)}


class CramersV(_ConfmatNominalMetric):
    """Cramer's V (``metrics.py:59``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import CramersV
        >>> metric = CramersV(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([0, 1, 2, 0, 1]), torch.tensor([0, 1, 2, 0, 2]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.5000
    """

    def __init__(
        self,
        num_classes: int,
        bias_correction: bool = True,
        nan_strategy: Literal["replace", "drop"] = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes, nan_strategy=nan_strategy, nan_replace_value=nan_replace_value, **kwargs)
        self.bias_correction = bias_correction

    def _update_fn(self, preds, target):
        return _cramers_v_update(preds, target, self.num_classes, self.nan_strategy, self.nan_replace_value)

    def _compute(self, state):
        return _cramers_v_compute(state["confmat"], self.bias_correction)


class PearsonsContingencyCoefficient(_ConfmatNominalMetric):
    """Pearson's contingency coefficient (``metrics.py:89``)."""

    def _update_fn(self, preds, target):
        return _pearsons_contingency_coefficient_update(
            preds, target, self.num_classes, self.nan_strategy, self.nan_replace_value
        )

    def _compute(self, state):
        return _pearsons_contingency_coefficient_compute(state["confmat"])


class TheilsU(_ConfmatNominalMetric):
    """Theil's U (``metrics.py:110``)."""

    def _update_fn(self, preds, target):
        return _theils_u_update(preds, target, self.num_classes, self.nan_strategy, self.nan_replace_value)

    def _compute(self, state):
        return _theils_u_compute(state["confmat"])


class TschuprowsT(_ConfmatNominalMetric):
    """Tschuprow's T (``metrics.py:129``)."""

    def __init__(
        self,
        num_classes: int,
        bias_correction: bool = True,
        nan_strategy: Literal["replace", "drop"] = "replace",
        nan_replace_value: Optional[float] = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes, nan_strategy=nan_strategy, nan_replace_value=nan_replace_value, **kwargs)
        self.bias_correction = bias_correction

    def _update_fn(self, preds, target):
        return _tschuprows_t_update(preds, target, self.num_classes, self.nan_strategy, self.nan_replace_value)

    def _compute(self, state):
        return _tschuprows_t_compute(state["confmat"], self.bias_correction)


class FleissKappa(Metric):
    """Fleiss' kappa (``metrics.py:159``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.nominal import FleissKappa
        >>> metric = FleissKappa(mode="counts", device="cpu")
        >>> metric.update(torch.tensor([[3, 2, 5], [4, 4, 2], [5, 3, 2]]))
        >>> print(f"{float(metric.compute()):.4f}")
        -0.0550
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, mode: Literal["counts", "probs"] = "counts", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if mode not in ("counts", "probs"):
            raise ValueError("Argument ``mode`` must be one of 'counts' or 'probs'.")
        self.mode = mode
        self.add_state("counts", default=[], dist_reduce_fx="cat")

    def _update(self, state: Dict[str, Any], ratings: Tensor) -> Dict[str, Any]:
        return {"counts": _fleiss_kappa_update(ratings, self.mode)}

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        return _fleiss_kappa_compute(state["counts"])
