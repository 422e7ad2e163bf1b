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
Spearman and Kendall correlations, cosine similarity, KL divergence, Tweedie deviance); clustering
(``clustering/``: the extrinsic scores over label pairs, with a float64 expected mutual
information, and Calinski-Harabasz, Davies-Bouldin and Dunn) and nominal association
(``nominal/``: Cramer's V, Tschuprow's T, Pearson's contingency coefficient, Theil's U, Fleiss'
kappa); the aggregation metrics; the retrieval metrics (``retrieval/``, the flat segment-reduce engine, and the
streaming ``approx="sketch"`` mode); the sketches (``sketch/``: the KLL and count-min sketches,
``StreamingQuantile``, ``StreamingHistogram``) and the keyed multi-tenant engine (``keyed/``); the
observability core (``obs/``: the telemetry registry and the engine's counters, the flight
recorder, live time series, the SLO burn-rate monitor) and the online layer (``online/``:
``Windowed``, ``Ema``, the drift detectors and ``DriftMonitor``); the pairwise distances
(``functional/pairwise/``) and the image-quality metrics (``image/``, ``functional/image/``: SSIM,
MS-SSIM, PSNR, PSNR-B, UQI, SAM, ERGAS, RASE, RMSE-SW, D-lambda, TV, VIF, image gradients); the
generative image metrics (``image/generative.py``: FID, KID, IS, MiFID, LPIPS, PPL, on feature
callables, with the pretrained-model adapters of ``utils/pretrained.py``); the audio domain
(``audio/``, ``functional/audio/``: SNR, SI-SDR, SI-SNR, C-SI-SNR, SA-SDR, SDR, PIT, SRMR, and PESQ and
STOI through their host packages); the text metrics that need no model (``text/``, ``functional/text/``:
BLEU, SacreBLEU, chrF, TER, EED, the edit distance and error rates, ROUGE, SQuAD, perplexity) and the
encoder-backed ones (BERTScore, InfoLM); the multimodal metrics (``multimodal/``: CLIPScore, CLIP-IQA);
detection (``detection/``, ``functional/detection/``: the IoU family, mean average precision with its greedy
COCO matcher on the device, panoptic quality);
operator composition (``CompositionalMetric``) and ``set_dtype``; state sync across processes
(``parallel/``: ``Metric.sync``/``unsync``/``sync_context``, sync on ``compute`` and on step, over
``torch.distributed``); the wrappers (``wrappers/``); and the engine's fused tiers
(``update_batches``, ``sweep_fn``, ``buffered``, the fused forward, the retrieval compute), which
run each step as one captured CUDA graph on the card (``ops/dispatch.py``); the robust layer (``robust/``:
the ``nan_policy`` guardrails, durable snapshots in the JAX package's format, the write-ahead update
journal) and ``plot`` (``utils/plot.py``); the serving tier (``serve/``: ``Metric.update_async`` through a
bounded window, a drain thread and pinned staging, the adaptive controller) with post-mortem bundles and serve
traces (``obs/bundle``, ``obs/trace``). ``ROADMAP.md`` lists what is still to port.

The top level exports what ``torchmetrics_tpu.__all__`` exports of the ported domains, under the
same names (the task wrappers and ``Dice`` of classification, the regression, clustering, nominal,
aggregation, retrieval, image, audio, text, multimodal and detection metrics, the wrappers, the streaming sketches, the keyed engine
and the serving tier's ``IngestEngine``, ``IngestTicket`` and ``ServeOptions``); the task-specific classes stay in ``classification``, as in the
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
from torchmetrics_tpu_torch.audio import (
    ComplexScaleInvariantSignalNoiseRatio,
    PerceptualEvaluationSpeechQuality,
    PermutationInvariantTraining,
    ScaleInvariantSignalDistortionRatio,
    ScaleInvariantSignalNoiseRatio,
    ShortTimeObjectiveIntelligibility,
    SignalDistortionRatio,
    SignalNoiseRatio,
    SourceAggregatedSignalDistortionRatio,
    SpeechReverberationModulationEnergyRatio,
)
from torchmetrics_tpu_torch.clustering import (
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
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.detection import (
    CompleteIntersectionOverUnion,
    DistanceIntersectionOverUnion,
    GeneralizedIntersectionOverUnion,
    IntersectionOverUnion,
    MeanAveragePrecision,
    ModifiedPanopticQuality,
    PanopticQuality,
)
from torchmetrics_tpu_torch.image import (
    ErrorRelativeGlobalDimensionlessSynthesis,
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    LearnedPerceptualImagePatchSimilarity,
    MemorizationInformedFrechetInceptionDistance,
    MultiScaleStructuralSimilarityIndexMeasure,
    PerceptualPathLength,
    PeakSignalNoiseRatio,
    PeakSignalNoiseRatioWithBlockedEffect,
    RelativeAverageSpectralError,
    RootMeanSquaredErrorUsingSlidingWindow,
    SpectralAngleMapper,
    SpectralDistortionIndex,
    StructuralSimilarityIndexMeasure,
    TotalVariation,
    UniversalImageQualityIndex,
    VisualInformationFidelity,
)
from torchmetrics_tpu_torch.keyed import KeyedMetric, KeyedMetricCollection
from torchmetrics_tpu_torch.metric import CompositionalMetric, Metric
from torchmetrics_tpu_torch.multimodal import CLIPImageQualityAssessment, CLIPScore
from torchmetrics_tpu_torch import obs, robust
from torchmetrics_tpu_torch.nominal import (
    CramersV,
    FleissKappa,
    PearsonsContingencyCoefficient,
    TheilsU,
    TschuprowsT,
)
from torchmetrics_tpu_torch.online import DriftMonitor, DriftSpec, Ema, EwmaBand, KsDrift, PsiDrift, Windowed
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
from torchmetrics_tpu_torch.serve import IngestEngine, IngestTicket, ServeOptions
from torchmetrics_tpu_torch.sketch import StreamingHistogram, StreamingQuantile
from torchmetrics_tpu_torch.text import (
    BERTScore,
    BLEUScore,
    CharErrorRate,
    CHRFScore,
    EditDistance,
    ExtendedEditDistance,
    InfoLM,
    MatchErrorRate,
    Perplexity,
    ROUGEScore,
    SacreBLEUScore,
    SQuAD,
    TranslationEditRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
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
    "AdjustedMutualInfoScore",
    "AdjustedRandScore",
    "AveragePrecision",
    "BootStrapper",
    "CalibrationError",
    "CalinskiHarabaszScore",
    "CatMetric",
    "ClasswiseWrapper",
    "CohenKappa",
    "CompletenessScore",
    "CompositionalMetric",
    "ConcordanceCorrCoef",
    "ConfusionMatrix",
    "CosineSimilarity",
    "CramersV",
    "DaviesBouldinScore",
    "Dice",
    "DunnIndex",
    "ExactMatch",
    "ExplainedVariance",
    "F1Score",
    "FBetaScore",
    "FleissKappa",
    "FowlkesMallowsIndex",
    "HammingDistance",
    "HingeLoss",
    "HomogeneityScore",
    "JaccardIndex",
    "KLDivergence",
    "KendallRankCorrCoef",
    "KeyedMetric",
    "KeyedMetricCollection",
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
    "MutualInfoScore",
    "NormalizedMutualInfoScore",
    "PearsonCorrCoef",
    "PearsonsContingencyCoefficient",
    "Precision",
    "PrecisionAtFixedRecall",
    "PrecisionRecallCurve",
    "R2Score",
    "ROC",
    "RandScore",
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
    "StreamingHistogram",
    "StreamingQuantile",
    "Specificity",
    "SpecificityAtSensitivity",
    "StatScores",
    "SumMetric",
    "SymmetricMeanAbsolutePercentageError",
    "TheilsU",
    "TschuprowsT",
    "TweedieDevianceScore",
    "VMeasureScore",
    "WeightedMeanAbsolutePercentageError",
    "obs",
    "robust",
    "Windowed",
    "Ema",
    "DriftMonitor",
    "DriftSpec",
    "EwmaBand",
    "KsDrift",
    "PsiDrift",
    # image
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "FrechetInceptionDistance",
    "InceptionScore",
    "KernelInceptionDistance",
    "LearnedPerceptualImagePatchSimilarity",
    "MemorizationInformedFrechetInceptionDistance",
    "PerceptualPathLength",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "PeakSignalNoiseRatio",
    "PeakSignalNoiseRatioWithBlockedEffect",
    "RelativeAverageSpectralError",
    "RootMeanSquaredErrorUsingSlidingWindow",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StructuralSimilarityIndexMeasure",
    "TotalVariation",
    "UniversalImageQualityIndex",
    "VisualInformationFidelity",
    # audio
    "ComplexScaleInvariantSignalNoiseRatio",
    "PerceptualEvaluationSpeechQuality",
    "PermutationInvariantTraining",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "ShortTimeObjectiveIntelligibility",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
    "SourceAggregatedSignalDistortionRatio",
    "SpeechReverberationModulationEnergyRatio",
    # detection
    "CompleteIntersectionOverUnion",
    "DistanceIntersectionOverUnion",
    "GeneralizedIntersectionOverUnion",
    "IntersectionOverUnion",
    "MeanAveragePrecision",
    "ModifiedPanopticQuality",
    "PanopticQuality",
    # multimodal
    "CLIPImageQualityAssessment",
    "CLIPScore",
    # text
    "BERTScore",
    "BLEUScore",
    "InfoLM",
    "CHRFScore",
    "CharErrorRate",
    "EditDistance",
    "ExtendedEditDistance",
    "ROUGEScore",
    "TranslationEditRate",
    "MatchErrorRate",
    "Perplexity",
    "SQuAD",
    "SacreBLEUScore",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
    # serving
    "IngestEngine",
    "IngestTicket",
    "ServeOptions",
]
