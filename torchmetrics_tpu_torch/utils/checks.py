"""Input checks (counterpart of ``torchmetrics_tpu/utils/checks.py``, reference ``checks.py:39``)."""
from __future__ import annotations

from torch import Tensor


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    """Raise if shapes differ."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {tuple(preds.shape)} and"
            f" {tuple(target.shape)}."
        )
