"""torchmetrics_tpu_torch.online: windowed monitoring and drift alarms (counterpart of
``torchmetrics_tpu.online``).

Sliding and EMA windows as fixed-shape metric states (``Windowed``, ``Ema``, or the
``Metric.windowed()`` / ``Metric.ema()`` / ``MetricCollection.windowed()`` seams), per-window value
emission into the always-on ``online.*`` live series, and drift detection (KS and PSI sketch to
sketch, EWMA control bands) alarmed through the SLO burn-rate machinery.
"""
from torchmetrics_tpu_torch.online.drift import (
    DriftDetector,
    DriftMonitor,
    DriftSpec,
    EwmaBand,
    KsDrift,
    PsiDrift,
    default_drift_specs,
)
from torchmetrics_tpu_torch.online.windowed import Ema, Windowed

__all__ = [
    "DriftDetector",
    "DriftMonitor",
    "DriftSpec",
    "Ema",
    "EwmaBand",
    "KsDrift",
    "PsiDrift",
    "Windowed",
    "default_drift_specs",
]
