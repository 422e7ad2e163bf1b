"""PyTorch and CUDA port of ``torchmetrics_tpu``, for NVIDIA Hopper (H100).

The port is a package of its own beside the JAX package, which stays the reference. It imports
``torch`` and numpy, never ``jax`` and nothing of ``torchmetrics_tpu``. Metrics run on CUDA
unless the caller passes ``device="cpu"``; the TPU's Pallas kernels become hand-written CUDA
kernels under ``csrc/``, built with ``nvcc`` at first use.

This first slice covers the multiclass stat-scores family (accuracy, precision, recall, F-beta)
and ``MetricCollection`` with compute groups.
"""
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric

__version__ = "0.1.0"

__all__ = ["Metric", "MetricCollection"]
