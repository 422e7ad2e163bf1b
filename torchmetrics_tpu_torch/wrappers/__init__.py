"""Wrapper metrics of the port (counterpart of ``torchmetrics_tpu/wrappers``): ``BootStrapper``,
``ClasswiseWrapper``, ``MetricTracker``, ``MinMaxMetric``, ``MultioutputWrapper``,
``MultitaskWrapper`` and ``Running``. Each syncs through the metrics it wraps."""
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric
from torchmetrics_tpu_torch.wrappers.bootstrapping import BootStrapper
from torchmetrics_tpu_torch.wrappers.classwise import ClasswiseWrapper
from torchmetrics_tpu_torch.wrappers.minmax import MinMaxMetric
from torchmetrics_tpu_torch.wrappers.multioutput import MultioutputWrapper
from torchmetrics_tpu_torch.wrappers.multitask import MultitaskWrapper
from torchmetrics_tpu_torch.wrappers.running import Running
from torchmetrics_tpu_torch.wrappers.tracker import MetricTracker

__all__ = [
    "BootStrapper",
    "ClasswiseWrapper",
    "MetricTracker",
    "MinMaxMetric",
    "MultioutputWrapper",
    "MultitaskWrapper",
    "Running",
    "WrapperMetric",
]
