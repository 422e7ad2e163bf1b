"""ClasswiseWrapper (counterpart of ``torchmetrics_tpu/wrappers/classwise.py``; reference
``src/torchmetrics/wrappers/classwise.py:27``)."""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


class ClasswiseWrapper(WrapperMetric):
    """Split a per-class output tensor into a ``{label: scalar}`` dict (reference ``classwise.py:27``).

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.16, 0.26, 0.58], [0.22, 0.61, 0.17], [0.71, 0.09, 0.20], [0.05, 0.82, 0.13]])
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> from torchmetrics_tpu_torch.wrappers import ClasswiseWrapper
        >>> metric = ClasswiseWrapper(MulticlassAccuracy(num_classes=3, average=None, device="cpu"))
        >>> metric.update(preds, target)
        >>> {k: round(float(v), 2) for k, v in sorted(metric.compute().items())}
        {'multiclassaccuracy_0': 0.5, 'multiclassaccuracy_1': 1.0, 'multiclassaccuracy_2': 1.0}
    """

    def __init__(
        self,
        metric: Metric,
        labels: Optional[List[str]] = None,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected argument `metric` to be an instance of `Metric` but got {metric}")
        kwargs.setdefault("device", metric.device)
        super().__init__(**kwargs)
        if labels is not None and not (isinstance(labels, list) and all(isinstance(lab, str) for lab in labels)):
            raise ValueError(f"Argument `labels` must be either `None` or a list of strings but got {labels}")
        if prefix is not None and not isinstance(prefix, str):
            raise ValueError(f"Argument `prefix` must be either `None` or a string but got {prefix}")
        if postfix is not None and not isinstance(postfix, str):
            raise ValueError(f"Argument `postfix` must be either `None` or a string but got {postfix}")
        self.metric = metric
        self.labels = labels
        self._prefix = prefix
        self._postfix = postfix
        self._update_count = 1

    def _convert(self, x) -> Dict[str, Any]:
        if not self._prefix and not self._postfix:
            prefix = f"{type(self.metric).__name__.lower()}_"
            postfix = ""
        else:
            prefix = self._prefix or ""
            postfix = self._postfix or ""
        if self.labels is None:
            return {f"{prefix}{i}{postfix}": val for i, val in enumerate(x)}
        return {f"{prefix}{lab}{postfix}": val for lab, val in zip(self.labels, x)}

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.metric.update(*args, **kwargs)
        self._update_called = True

    def compute(self) -> Dict[str, Any]:
        return self._convert(self.metric.compute())

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        return self._convert(self.metric(*args, **kwargs))

    def reset(self) -> None:
        self.metric.reset()

    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        return self.metric._filter_kwargs(**kwargs)
