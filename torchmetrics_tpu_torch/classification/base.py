"""Task-dispatch wrapper base (counterpart of ``torchmetrics_tpu/classification/base.py``, reference
``classification/base.py:19``)."""
from __future__ import annotations

from typing import Any

from torchmetrics_tpu_torch.metric import Metric


class _ClassificationTaskWrapper(Metric):
    """Base of wrapper classes like ``AUROC(task=...)``, whose ``__new__`` returns a task class."""

    def update(self, *args: Any, **kwargs: Any) -> None:
        raise NotImplementedError(
            f"{self.__class__.__name__} metric does not have an `update` method. This is a wrapper class"
            " and you should instead instantiate it with an appropriate task argument."
        )

    def compute(self) -> None:
        raise NotImplementedError(
            f"{self.__class__.__name__} metric does not have a `compute` method. This is a wrapper class"
            " and you should instead instantiate it with an appropriate task argument."
        )
