"""Audio module metrics (counterpart of ``torchmetrics_tpu/audio/``)."""
from torchmetrics_tpu_torch.audio.metrics import (
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

__all__ = [
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
]
