"""Module metrics for classification (the multiclass stat-scores slice and the curve family of
``torchmetrics_tpu.classification``)."""
from torchmetrics_tpu_torch.classification.accuracy import MulticlassAccuracy
from torchmetrics_tpu_torch.classification.auroc import AUROC, BinaryAUROC, MulticlassAUROC, MultilabelAUROC
from torchmetrics_tpu_torch.classification.average_precision import (
    AveragePrecision,
    BinaryAveragePrecision,
    MulticlassAveragePrecision,
    MultilabelAveragePrecision,
)
from torchmetrics_tpu_torch.classification.f_beta import MulticlassF1Score, MulticlassFBetaScore
from torchmetrics_tpu_torch.classification.precision_recall import MulticlassPrecision, MulticlassRecall
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    PrecisionRecallCurve,
)
from torchmetrics_tpu_torch.classification.roc import ROC, BinaryROC, MulticlassROC, MultilabelROC
from torchmetrics_tpu_torch.classification.stat_scores import MulticlassStatScores

__all__ = [
    "AUROC",
    "AveragePrecision",
    "BinaryAUROC",
    "BinaryAveragePrecision",
    "BinaryPrecisionRecallCurve",
    "BinaryROC",
    "MulticlassAUROC",
    "MulticlassAccuracy",
    "MulticlassAveragePrecision",
    "MulticlassF1Score",
    "MulticlassFBetaScore",
    "MulticlassPrecision",
    "MulticlassPrecisionRecallCurve",
    "MulticlassROC",
    "MulticlassRecall",
    "MulticlassStatScores",
    "MultilabelAUROC",
    "MultilabelAveragePrecision",
    "MultilabelPrecisionRecallCurve",
    "MultilabelROC",
    "PrecisionRecallCurve",
    "ROC",
]
