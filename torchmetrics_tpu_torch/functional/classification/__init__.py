"""Functional classification metrics of the PyTorch port (multiclass slice)."""
from torchmetrics_tpu_torch.functional.classification.accuracy import multiclass_accuracy
from torchmetrics_tpu_torch.functional.classification.f_beta import multiclass_f1_score, multiclass_fbeta_score
from torchmetrics_tpu_torch.functional.classification.precision_recall import multiclass_precision, multiclass_recall
from torchmetrics_tpu_torch.functional.classification.stat_scores import multiclass_stat_scores

__all__ = [
    "multiclass_accuracy",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_precision",
    "multiclass_recall",
    "multiclass_stat_scores",
]
