"""Multiclass accuracy (counterpart of ``torchmetrics_tpu/classification/accuracy.py:43``)."""
from __future__ import annotations

from torchmetrics_tpu_torch.classification.stat_scores import MulticlassStatScores
from torchmetrics_tpu_torch.functional.classification.accuracy import _accuracy_reduce


class MulticlassAccuracy(MulticlassStatScores):
    """Multiclass accuracy (reference ``accuracy.py:150``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> metric = MulticlassAccuracy(num_classes=3, device="cpu")  # default average='macro'
        >>> metric.update(torch.tensor([[0.16, 0.26, 0.58], [0.22, 0.61, 0.17],
        ...                             [0.71, 0.09, 0.20], [0.05, 0.82, 0.13]]), torch.tensor([2, 1, 0, 0]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.8333
    """

    higher_is_better = True

    def _compute(self, state):
        return _accuracy_reduce(
            state["tp"], state["fp"], state["tn"], state["fn"], average=self.average,
            multidim_average=self.multidim_average, top_k=self.top_k,
        )
