"""Functional metrics of the PyTorch port (counterpart of ``torchmetrics_tpu.functional``)."""
from torchmetrics_tpu_torch.functional.classification import (
    multiclass_accuracy,
    multiclass_f1_score,
    multiclass_fbeta_score,
    multiclass_precision,
    multiclass_recall,
    multiclass_stat_scores,
)

__all__ = [
    "multiclass_accuracy",
    "multiclass_f1_score",
    "multiclass_fbeta_score",
    "multiclass_precision",
    "multiclass_recall",
    "multiclass_stat_scores",
]
