"""PyTorch and CUDA port of ``torchmetrics_tpu``, for NVIDIA Hopper (H100).

The port is a package of its own beside the JAX package, which stays the reference. It imports
``torch`` and numpy, never ``jax`` and nothing of ``torchmetrics_tpu``. Metrics run on CUDA
unless the caller passes ``device="cpu"``; the TPU's Pallas kernels become hand-written CUDA
kernels under ``csrc/``, built with ``nvcc`` at first use.

Ported so far: ``Metric`` and ``MetricCollection`` with compute groups; the whole classification
domain (``classification/``: the stat-scores and confusion-matrix families of every task with
specificity, Hamming distance, Jaccard index, Cohen's kappa and MCC, exact match, Dice, hinge loss,
the multilabel ranking metrics, group fairness, the curve family with its fixed-point metrics in
exact, binned and sketched states, and calibration error); the regression domain
(``regression/``: the sum-state errors, R², RSE and explained variance, the Pearson, concordance,
Spearman and Kendall correlations, cosine similarity, KL divergence, Tweedie deviance); the
aggregation metrics; the retrieval metrics (``retrieval/``, the flat segment-reduce engine);
operator composition (``CompositionalMetric``) and ``set_dtype``; state sync across processes
(``parallel/``: ``Metric.sync``/``unsync``/``sync_context``, sync on ``compute`` and on step, over
``torch.distributed``); the wrappers (``wrappers/``); and the engine's fused tiers
(``update_batches``, ``sweep_fn``, ``buffered``, the fused forward, the retrieval compute), which
run each step as one captured CUDA graph on the card (``ops/dispatch.py``). ``ROADMAP.md`` lists what is still to port.

The top level exports what ``torchmetrics_tpu.__all__`` exports of the ported domains, under the
same names (the task wrappers and ``Dice`` of classification, the regression, aggregation and
retrieval metrics, the wrappers); the task-specific classes stay in ``classification``, as in the
JAX package.
"""
from torchmetrics_tpu_torch.aggregation import (
    CatMetric,
    MaxMetric,
    MeanMetric,
    MinMetric,
    RunningMean,
    RunningSum,
    SumMetric,
)
from torchmetrics_tpu_torch.classification import (
    AUROC,
    ROC,
    Accuracy,
    AveragePrecision,
    CalibrationError,
    CohenKappa,
    ConfusionMatrix,
    Dice,
    ExactMatch,
    F1Score,
    FBetaScore,
    HammingDistance,
    HingeLoss,
    JaccardIndex,
    MatthewsCorrCoef,
    Precision,
    PrecisionAtFixedRecall,
    PrecisionRecallCurve,
    Recall,
    RecallAtFixedPrecision,
    Specificity,
    SpecificityAtSensitivity,
    StatScores,
)
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import CompositionalMetric, Metric
from torchmetrics_tpu_torch.regression import (
    ConcordanceCorrCoef,
    CosineSimilarity,
    ExplainedVariance,
    KLDivergence,
    KendallRankCorrCoef,
    LogCoshError,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    MinkowskiDistance,
    PearsonCorrCoef,
    R2Score,
    RelativeSquaredError,
    SpearmanCorrCoef,
    SymmetricMeanAbsolutePercentageError,
    TweedieDevianceScore,
    WeightedMeanAbsolutePercentageError,
)
from torchmetrics_tpu_torch.retrieval import (
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalPrecisionRecallCurve,
    RetrievalRecall,
    RetrievalRecallAtFixedPrecision,
    RetrievalRPrecision,
)
from torchmetrics_tpu_torch.wrappers import (
    BootStrapper,
    ClasswiseWrapper,
    MetricTracker,
    MinMaxMetric,
    MultioutputWrapper,
    MultitaskWrapper,
)

__version__ = "0.1.0"

__all__ = [
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BootStrapper",
    "CalibrationError",
    "CatMetric",
    "ClasswiseWrapper",
    "CohenKappa",
    "CompositionalMetric",
    "ConcordanceCorrCoef",
    "ConfusionMatrix",
    "CosineSimilarity",
    "Dice",
    "ExactMatch",
    "ExplainedVariance",
    "F1Score",
    "FBetaScore",
    "HammingDistance",
    "HingeLoss",
    "JaccardIndex",
    "KLDivergence",
    "KendallRankCorrCoef",
    "LogCoshError",
    "MatthewsCorrCoef",
    "MaxMetric",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanMetric",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "Metric",
    "MetricCollection",
    "MetricTracker",
    "MinMaxMetric",
    "MinMetric",
    "MinkowskiDistance",
    "MultioutputWrapper",
    "MultitaskWrapper",
    "PearsonCorrCoef",
    "Precision",
    "PrecisionAtFixedRecall",
    "PrecisionRecallCurve",
    "R2Score",
    "ROC",
    "Recall",
    "RecallAtFixedPrecision",
    "RelativeSquaredError",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRPrecision",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
    "RunningMean",
    "RunningSum",
    "SpearmanCorrCoef",
    "Specificity",
    "SpecificityAtSensitivity",
    "StatScores",
    "SumMetric",
    "SymmetricMeanAbsolutePercentageError",
    "TweedieDevianceScore",
    "WeightedMeanAbsolutePercentageError",
]
