"""Multimodal module metrics of the port (counterpart of ``torchmetrics_tpu/multimodal/``)."""
from torchmetrics_tpu_torch.multimodal.clip import CLIPImageQualityAssessment, CLIPScore

__all__ = ["CLIPImageQualityAssessment", "CLIPScore"]
