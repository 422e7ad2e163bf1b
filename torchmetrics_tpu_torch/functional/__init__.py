"""Functional metrics of the PyTorch port (counterpart of ``torchmetrics_tpu.functional``)."""
from torchmetrics_tpu_torch.functional import classification as _classification
from torchmetrics_tpu_torch.functional import regression as _regression
from torchmetrics_tpu_torch.functional import retrieval as _retrieval
from torchmetrics_tpu_torch.functional.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.regression import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.retrieval import *  # noqa: F401,F403

__all__ = _classification.__all__ + _regression.__all__ + _retrieval.__all__
