"""MetricTracker (counterpart of ``torchmetrics_tpu/wrappers/tracker.py``; reference
``src/torchmetrics/wrappers/tracker.py:31``)."""
from __future__ import annotations

from typing import Any, List, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric
from torchmetrics_tpu_torch.wrappers.multitask import _device_of


def _host(value: Any) -> np.ndarray:
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


class MetricTracker(WrapperMetric):
    """Track a metric (or collection) over epochs: ``increment()`` per epoch, ``best_metric()``
    at the end (reference ``tracker.py:31,108``). ``maximize`` is one bool, or one per member of a
    collection, in its order.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.16, 0.26, 0.58], [0.22, 0.61, 0.17], [0.71, 0.09, 0.20], [0.05, 0.82, 0.13]])
        >>> target = torch.tensor([2, 1, 0, 0])
        >>> from torchmetrics_tpu_torch.classification import MulticlassAccuracy
        >>> from torchmetrics_tpu_torch.wrappers import MetricTracker
        >>> tracker = MetricTracker(MulticlassAccuracy(num_classes=3, average='micro', device="cpu"))
        >>> for epoch in range(2):
        ...     tracker.increment()
        ...     tracker.update(preds, target)
        >>> best, step = tracker.best_metric(return_step=True)
        >>> print(f"{float(best):.4f}", step)
        0.7500 0
    """

    def __init__(self, metric: Union[Metric, MetricCollection], maximize: Union[bool, List[bool]] = True) -> None:
        if not isinstance(metric, (Metric, MetricCollection)):
            raise TypeError(
                "Metric arg need to be an instance of a torchmetrics_tpu_torch"
                f" `Metric` or `MetricCollection` but got {metric}"
            )
        super().__init__(device=_device_of(metric))
        self._base_metric = metric
        self._metrics: List[Union[Metric, MetricCollection]] = []
        if not isinstance(maximize, (bool, list)):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list) and not all(isinstance(m, bool) for m in maximize):
            raise ValueError("Argument `maximize` should either be a single bool or list of bool")
        if isinstance(maximize, list) and isinstance(metric, MetricCollection) and len(maximize) != len(metric):
            raise ValueError("The len of argument `maximize` should match the length of the metric collection")
        self.maximize = maximize
        self._increment_called = False

    @property
    def n_steps(self) -> int:
        """Number of times increment has been called."""
        self._check_for_increment("n_steps")
        return len(self._metrics)

    def increment(self) -> None:
        """Start tracking a new version (e.g. a new epoch) of the metric."""
        self._increment_called = True
        self._metrics.append(self._base_metric.clone())
        self._metrics[-1].reset()

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._check_for_increment("update")
        self._metrics[-1].update(*args, **kwargs)
        self._update_called = True

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._check_for_increment("forward")
        self._update_called = True
        return self._metrics[-1](*args, **kwargs)

    def compute(self) -> Any:
        self._check_for_increment("compute")
        return self._metrics[-1].compute()

    def compute_all(self) -> Any:
        """Stacked results of all tracked versions (reference ``tracker.py:142``)."""
        self._check_for_increment("compute_all")
        res = [metric.compute() for metric in self._metrics]
        if isinstance(self._base_metric, MetricCollection):
            return {k: torch.stack([torch.as_tensor(r[k]) for r in res], dim=0) for k in res[0]}
        return torch.stack([torch.as_tensor(r) for r in res], dim=0)

    def reset(self) -> None:
        """Reset the current metric being tracked."""
        if self._metrics:
            self._metrics[-1].reset()

    def reset_all(self) -> None:
        for metric in self._metrics:
            metric.reset()

    def best_metric(self, return_step: bool = False) -> Union[Any, Tuple[Any, Any]]:
        """The best value (and its step) over the tracked versions (reference ``tracker.py:160``), as
        Python floats and ints; ``None`` with a warning where a value is not a scalar."""
        res = self.compute_all()
        if isinstance(res, dict):
            maximize = self.maximize if isinstance(self.maximize, list) else [self.maximize] * len(res)
            value, idx = {}, {}
            for i, (k, v) in enumerate(res.items()):
                try:
                    arr = _host(v)
                    fn = np.argmax if maximize[i] else np.argmin
                    best = int(fn(arr))
                    value[k], idx[k] = float(arr[best]), best
                except (ValueError, TypeError) as err:
                    rank_zero_warn(
                        f"Encountered the following error when trying to get the best metric for metric {k}:"
                        f"{err}. This is probably because the metric in the collection is lacking a `higher_is_better`"
                        " flag or produces a non-scalar output. Returning `None` instead.",
                        UserWarning,
                    )
                    value[k], idx[k] = None, None
            if return_step:
                return value, idx
            return value
        try:
            arr = _host(res)
            fn = np.argmax if self.maximize else np.argmin
            best = int(fn(arr))
            if return_step:
                return float(arr[best]), best
            return float(arr[best])
        except (ValueError, TypeError) as err:
            rank_zero_warn(
                f"Encountered the following error when trying to get the best metric: {err}."
                " Returning `None` instead.",
                UserWarning,
            )
            if return_step:
                return None, None
            return None

    def _check_for_increment(self, method: str) -> None:
        if not self._increment_called:
            raise ValueError(f"`{method}` cannot be called before `.increment()` has been called.")
