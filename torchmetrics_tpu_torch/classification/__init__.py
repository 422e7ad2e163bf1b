"""Module metrics for classification (multiclass slice of ``torchmetrics_tpu.classification``)."""
from torchmetrics_tpu_torch.classification.accuracy import MulticlassAccuracy
from torchmetrics_tpu_torch.classification.f_beta import MulticlassF1Score, MulticlassFBetaScore
from torchmetrics_tpu_torch.classification.precision_recall import MulticlassPrecision, MulticlassRecall
from torchmetrics_tpu_torch.classification.stat_scores import MulticlassStatScores

__all__ = [
    "MulticlassAccuracy",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassPrecision",
    "MulticlassRecall",
    "MulticlassStatScores",
]
