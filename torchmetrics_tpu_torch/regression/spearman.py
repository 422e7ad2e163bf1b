"""SpearmanCorrCoef and KendallRankCorrCoef (counterpart of ``torchmetrics_tpu/regression/spearman.py``):
ranks need every sample, so the scores accumulate in ``cat`` list states, cast to float32. As in
the JAX package, the updates check nothing."""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.kendall import _check_kendall_args, _kendall_corrcoef_compute
from torchmetrics_tpu_torch.functional.regression.spearman import _spearman_corrcoef_compute
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.regression.base import _check_num_outputs
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn


class _RankCorrelation(Metric):
    is_differentiable = False

    def _create_state(self, num_outputs: int) -> None:
        _check_num_outputs(num_outputs, "an int larger than 0")
        self.num_outputs = num_outputs
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def _update(self, state, preds, target):
        return {"preds": preds.to(torch.float32), "target": target.to(torch.float32)}


class SpearmanCorrCoef(_RankCorrelation):
    """Spearman rank correlation (``spearman.py:20``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import SpearmanCorrCoef
        >>> metric = SpearmanCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    higher_is_better = True
    full_state_update = False

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        rank_zero_warn(
            "Metric `SpearmanCorrcoef` will save all targets and predictions in the buffer."
            " For large datasets, this may lead to a large memory footprint."
        )
        self._create_state(num_outputs)

    def _compute(self, state):
        return _spearman_corrcoef_compute(state["preds"], state["target"])


class KendallRankCorrCoef(_RankCorrelation):
    """Kendall rank correlation (``spearman.py:59``); with ``t_test`` the compute returns
    ``(tau, p_value)``."""
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    higher_is_better = None
    full_state_update = True

    def __init__(self, variant: str = "b", t_test: bool = False, alternative: Optional[str] = "two-sided",
                 num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_kendall_args(variant, t_test, alternative)
        self.variant = variant
        self.t_test = t_test
        self.alternative = alternative
        self._create_state(num_outputs)

    def _compute(self, state):
        return _kendall_corrcoef_compute(state["preds"], state["target"], self.variant, self.t_test, self.alternative)
