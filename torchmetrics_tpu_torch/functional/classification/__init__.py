"""Functional classification metrics of the PyTorch port (multiclass stat scores and the curve family)."""
from torchmetrics_tpu_torch.functional.classification.accuracy import multiclass_accuracy
from torchmetrics_tpu_torch.functional.classification.auroc import auroc, binary_auroc, multiclass_auroc, multilabel_auroc
from torchmetrics_tpu_torch.functional.classification.average_precision import (
    average_precision,
    binary_average_precision,
    multiclass_average_precision,
    multilabel_average_precision,
)
from torchmetrics_tpu_torch.functional.classification.f_beta import multiclass_f1_score, multiclass_fbeta_score
from torchmetrics_tpu_torch.functional.classification.precision_recall import multiclass_precision, multiclass_recall
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    binary_precision_recall_curve,
    multiclass_precision_recall_curve,
    multilabel_precision_recall_curve,
    precision_recall_curve,
)
from torchmetrics_tpu_torch.functional.classification.roc import binary_roc, multiclass_roc, multilabel_roc, roc
from torchmetrics_tpu_torch.functional.classification.stat_scores import multiclass_stat_scores

__all__ = [
    "auroc",
    "average_precision",
    "binary_auroc",
    "binary_average_precision",
    "binary_precision_recall_curve",
    "binary_roc",
    "multiclass_accuracy",
    "multiclass_auroc",
    "multiclass_average_precision",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_precision",
    "multiclass_precision_recall_curve",
    "multiclass_recall",
    "multiclass_roc",
    "multiclass_stat_scores",
    "multilabel_auroc",
    "multilabel_average_precision",
    "multilabel_precision_recall_curve",
    "multilabel_roc",
    "precision_recall_curve",
    "roc",
]
