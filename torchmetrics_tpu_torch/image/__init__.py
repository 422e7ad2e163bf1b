"""Image module metrics (counterpart of ``torchmetrics_tpu/image/__init__.py``): the generative metrics
of ``generative.py`` and the image-quality metrics of ``metrics.py``."""
from torchmetrics_tpu_torch.image.generative import (
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    LearnedPerceptualImagePatchSimilarity,
    MemorizationInformedFrechetInceptionDistance,
    PerceptualPathLength,
    perceptual_path_length,
)
from torchmetrics_tpu_torch.image.metrics import (
    ErrorRelativeGlobalDimensionlessSynthesis,
    MultiScaleStructuralSimilarityIndexMeasure,
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

__all__ = [
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
]
