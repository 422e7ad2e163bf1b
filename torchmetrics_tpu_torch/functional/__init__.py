"""Functional metrics of the PyTorch port (counterpart of ``torchmetrics_tpu.functional``)."""
from torchmetrics_tpu_torch.functional.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.classification import __all__  # noqa: F401
