"""ConcordanceCorrCoef (counterpart of ``torchmetrics_tpu/regression/concordance.py``): the Pearson
running state, so the two form one compute group."""
from __future__ import annotations

from torchmetrics_tpu_torch.functional.regression.concordance import _concordance_corrcoef_compute
from torchmetrics_tpu_torch.regression.pearson import PearsonCorrCoef


class ConcordanceCorrCoef(PearsonCorrCoef):
    """Concordance correlation coefficient (``concordance.py:8``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import ConcordanceCorrCoef
        >>> metric = ConcordanceCorrCoef(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.9777
    """
    plot_lower_bound = -1.0
    plot_upper_bound = 1.0

    def _compute(self, state):
        return _concordance_corrcoef_compute(*self._merged_state(state))
