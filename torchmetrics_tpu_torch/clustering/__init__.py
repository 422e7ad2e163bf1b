"""Module clustering metrics (counterpart of ``torchmetrics_tpu.clustering``): the nine extrinsic
scores over ``cat`` states of label pairs and Calinski-Harabasz, Davies-Bouldin and Dunn over
``cat`` states of data and labels."""
from torchmetrics_tpu_torch.clustering.metrics import (
    AdjustedMutualInfoScore,
    AdjustedRandScore,
    CalinskiHarabaszScore,
    CompletenessScore,
    DaviesBouldinScore,
    DunnIndex,
    FowlkesMallowsIndex,
    HomogeneityScore,
    MutualInfoScore,
    NormalizedMutualInfoScore,
    RandScore,
    VMeasureScore,
)

__all__ = [
    "AdjustedMutualInfoScore",
    "AdjustedRandScore",
    "CalinskiHarabaszScore",
    "CompletenessScore",
    "DaviesBouldinScore",
    "DunnIndex",
    "FowlkesMallowsIndex",
    "HomogeneityScore",
    "MutualInfoScore",
    "NormalizedMutualInfoScore",
    "RandScore",
    "VMeasureScore",
]
