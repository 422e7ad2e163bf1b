"""Multiclass precision and recall (counterpart of
``torchmetrics_tpu/classification/precision_recall.py:31,75``)."""
from __future__ import annotations

from torchmetrics_tpu_torch.classification.stat_scores import MulticlassStatScores
from torchmetrics_tpu_torch.functional.classification.precision_recall import _precision_recall_reduce


class MulticlassPrecision(MulticlassStatScores):
    higher_is_better = True

    def _compute(self, state):
        return _precision_recall_reduce(
            "precision", state["tp"], state["fp"], state["tn"], state["fn"], average=self.average,
            multidim_average=self.multidim_average, top_k=self.top_k,
        )


class MulticlassRecall(MulticlassStatScores):
    higher_is_better = True

    def _compute(self, state):
        return _precision_recall_reduce(
            "recall", state["tp"], state["fp"], state["tn"], state["fn"], average=self.average,
            multidim_average=self.multidim_average, top_k=self.top_k,
        )
