"""Module metrics for regression (counterpart of ``torchmetrics_tpu.regression``): the sum-state
errors (MSE, MAE, MSLE, MAPE, SMAPE, WMAPE, LogCosh, Minkowski, Tweedie deviance, KL divergence),
the moment sums of R², RSE and explained variance, the running Pearson and concordance states, and
the list states of cosine similarity, Spearman and Kendall."""
from torchmetrics_tpu_torch.regression.concordance import ConcordanceCorrCoef
from torchmetrics_tpu_torch.regression.explained_variance import ExplainedVariance
from torchmetrics_tpu_torch.regression.mape import (
    MeanAbsolutePercentageError,
    SymmetricMeanAbsolutePercentageError,
    WeightedMeanAbsolutePercentageError,
)
from torchmetrics_tpu_torch.regression.misc import (
    CosineSimilarity,
    KLDivergence,
    LogCoshError,
    MinkowskiDistance,
    TweedieDevianceScore,
)
from torchmetrics_tpu_torch.regression.mse import MeanAbsoluteError, MeanSquaredError, MeanSquaredLogError
from torchmetrics_tpu_torch.regression.pearson import PearsonCorrCoef
from torchmetrics_tpu_torch.regression.r2 import R2Score, RelativeSquaredError
from torchmetrics_tpu_torch.regression.spearman import KendallRankCorrCoef, SpearmanCorrCoef

__all__ = [
    "ConcordanceCorrCoef",
    "CosineSimilarity",
    "ExplainedVariance",
    "KLDivergence",
    "KendallRankCorrCoef",
    "LogCoshError",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "MinkowskiDistance",
    "PearsonCorrCoef",
    "R2Score",
    "RelativeSquaredError",
    "SpearmanCorrCoef",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
]
