"""Functional multimodal metrics of the port (counterpart of ``torchmetrics_tpu/functional/multimodal/``)."""
from torchmetrics_tpu_torch.functional.multimodal.clip import clip_image_quality_assessment, clip_score

__all__ = ["clip_image_quality_assessment", "clip_score"]
