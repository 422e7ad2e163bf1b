"""Wrapper metrics of the port (counterpart of ``torchmetrics_tpu/wrappers``): ``Running`` so far."""
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric
from torchmetrics_tpu_torch.wrappers.running import Running

__all__ = ["Running", "WrapperMetric"]
