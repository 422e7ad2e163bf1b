"""Shared helpers of the PyTorch port (counterpart of ``torchmetrics_tpu/utils``)."""
