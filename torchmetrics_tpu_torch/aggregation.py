"""Aggregation metrics: Max, Min, Sum, Cat, Mean, and their running-window forms.

Counterpart of ``torchmetrics_tpu/aggregation.py`` (``BaseAggregator:28``, ``MaxMetric:81``,
``MinMetric:107``, ``SumMetric:133``, ``CatMetric:156``, ``MeanMetric:189``, ``RunningMean:242``,
``RunningSum:258``; reference ``src/torchmetrics/aggregation.py``).

NaN handling is a mask and fill inside the update, as in the JAX package: an ignored value
contributes the reduction's identity (0 to sums, -inf to max, +inf to min), and a float
``nan_strategy`` imputes that value. The fill then maps +-inf to the largest finite float32
values, as ``jnp.nan_to_num`` does, the filled value included. ``'error'`` and ``'warn'`` are host
checks in ``_validate``, which runs before any graph step. ``CatMetric`` drops NaNs on the host,
so its update stays eager (``jit_update = False``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.compute import _safe_divide
from torchmetrics_tpu_torch.utils.data import dim_zero_cat
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn
from torchmetrics_tpu_torch.wrappers.running import Running as _Running


class BaseAggregator(Metric):
    """Base class for aggregation metrics (reference ``aggregation.py:30``)."""

    is_differentiable = None
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        fn: Optional[str],
        default_value: Union[Tensor, List],
        nan_strategy: Union[str, float] = "error",
        state_name: str = "value",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_nan_strategy = ("error", "warn", "ignore")
        if nan_strategy not in allowed_nan_strategy and not isinstance(nan_strategy, float):
            raise ValueError(
                f"Arg `nan_strategy` should either be a float or one of {allowed_nan_strategy} but got {nan_strategy}."
            )
        self.nan_strategy = nan_strategy
        self.add_state(state_name, default=default_value, dist_reduce_fx=fn)
        self.state_name = state_name

    def _should_validate(self) -> bool:
        return self.nan_strategy in ("error", "warn")

    def _validate(self, *args: Any, **kwargs: Any) -> None:
        for x in list(args) + list(kwargs.values()):
            if x is None:
                continue
            if bool(torch.isnan(x.to(torch.float32)).any()):
                if self.nan_strategy == "error":
                    raise RuntimeError("Encountered `nan` values in tensor")
                rank_zero_warn("Encountered `nan` values in tensor. Will be removed.", UserWarning)

    def _nan_mask_and_fill(self, x: Tensor, fill: float) -> Tensor:
        """NaNs replaced by ``fill`` (the identity element) or by a float ``nan_strategy``, then
        +-inf by the largest finite float32 values, as ``jnp.nan_to_num`` does."""
        x = x.to(torch.float32)
        value = self.nan_strategy if isinstance(self.nan_strategy, float) else fill
        return torch.nan_to_num(torch.where(torch.isnan(x), value, x), nan=math.nan)

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        return state[self.state_name]


class MaxMetric(BaseAggregator):
    """Running maximum of a stream of values (reference ``aggregation.py:114``).

    Example:
        >>> import numpy as np
        >>> from torchmetrics_tpu_torch.aggregation import MaxMetric
        >>> metric = MaxMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(np.array([2.0, 0.5]))
        >>> float(metric.compute())
        2.0
    """

    full_state_update = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("max", torch.tensor(-math.inf), nan_strategy, state_name="max_value", **kwargs)

    def _update(self, state: Dict[str, Tensor], value: Tensor) -> Dict[str, Tensor]:
        if value.numel() == 0:  # an empty update is a no-op
            return {"max_value": state["max_value"]}
        return {"max_value": torch.maximum(state["max_value"], torch.max(self._nan_mask_and_fill(value, -math.inf)))}


class MinMetric(BaseAggregator):
    """Running minimum of a stream of values (reference ``aggregation.py:219``).

    Example:
        >>> import numpy as np
        >>> from torchmetrics_tpu_torch.aggregation import MinMetric
        >>> metric = MinMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(np.array([2.0, 0.5]))
        >>> float(metric.compute())
        0.5
    """

    full_state_update = True

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("min", torch.tensor(math.inf), nan_strategy, state_name="min_value", **kwargs)

    def _update(self, state: Dict[str, Tensor], value: Tensor) -> Dict[str, Tensor]:
        if value.numel() == 0:  # an empty update is a no-op
            return {"min_value": state["min_value"]}
        return {"min_value": torch.minimum(state["min_value"], torch.min(self._nan_mask_and_fill(value, math.inf)))}


class SumMetric(BaseAggregator):
    """Running sum of a stream of values (reference ``aggregation.py:324``).

    Example:
        >>> import numpy as np
        >>> from torchmetrics_tpu_torch.aggregation import SumMetric
        >>> metric = SumMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(np.array([2.0, 3.0]))
        >>> float(metric.compute())
        6.0
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, state_name="sum_value", **kwargs)

    def _update(self, state: Dict[str, Tensor], value: Tensor) -> Dict[str, Tensor]:
        return {"sum_value": state["sum_value"] + torch.sum(self._nan_mask_and_fill(value, 0.0))}


class CatMetric(BaseAggregator):
    """Concatenate a stream of values (reference ``aggregation.py:429``).

    Example:
        >>> import numpy as np
        >>> from torchmetrics_tpu_torch.aggregation import CatMetric
        >>> metric = CatMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(np.array([2.0, 3.0]))
        >>> metric.compute().tolist()
        [1.0, 2.0, 3.0]
    """

    # dropping NaNs changes the output shape, so the update stays eager
    jit_update = False

    def __init__(self, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__("cat", [], nan_strategy, state_name="value", **kwargs)

    def _update(self, state: Dict[str, Tensor], value: Tensor) -> Dict[str, Tensor]:
        v = self._nan_mask_and_fill(value, math.nan)
        if self.nan_strategy in ("ignore", "warn"):
            v = v.reshape(-1)
            v = v[~torch.isnan(v)]
        return {"value": torch.atleast_1d(v)}

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        val = state["value"]
        if isinstance(val, list):
            return dim_zero_cat(val) if val else torch.zeros((0,), device=self.device)
        return val


class MeanMetric(BaseAggregator):
    """Weighted running mean of a stream of values (reference ``aggregation.py:493``).

    ``empty_result`` is the value of ``compute()`` on zero total weight (an untouched metric, or
    one whose every input was NaN-masked away): ``0.0`` by default, or ``float("nan")`` for the
    reference torchmetrics' semantics.

    Example:
        >>> import numpy as np
        >>> from torchmetrics_tpu_torch.aggregation import MeanMetric
        >>> metric = MeanMetric(device="cpu")
        >>> metric.update(1.0)
        >>> metric.update(np.array([2.0, 3.0]))
        >>> float(metric.compute())
        2.0
        >>> float(MeanMetric(device="cpu").compute())  # zero observations: well-defined, not NaN
        0.0
    """

    def __init__(self, nan_strategy: Union[str, float] = "warn", empty_result: float = 0.0, **kwargs: Any) -> None:
        super().__init__("sum", torch.tensor(0.0), nan_strategy, state_name="mean_value", **kwargs)
        if not isinstance(empty_result, (int, float)):
            raise ValueError(f"Arg `empty_result` should be a float (0.0 or nan), but got {empty_result!r}")
        self.empty_result = float(empty_result)
        self.add_state("weight", default=torch.tensor(0.0), dist_reduce_fx="sum")

    def _update(self, state: Dict[str, Tensor], value: Tensor, weight: Optional[Tensor] = None) -> Dict[str, Tensor]:
        value = value.to(torch.float32)
        weight = torch.ones_like(value) if weight is None else torch.broadcast_to(weight.to(torch.float32), value.shape)
        nan_mask = torch.isnan(value) | torch.isnan(weight)
        # a float strategy imputes value and weight; ignore/warn give NaN entries zero weight
        fill = self.nan_strategy if isinstance(self.nan_strategy, float) else 0.0
        value = torch.where(nan_mask, fill, value)
        weight = torch.where(nan_mask, fill, weight)
        return {
            "mean_value": state["mean_value"] + torch.sum(value * weight),
            "weight": state["weight"] + torch.sum(weight),
        }

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        # zero total weight gives `empty_result` exactly, not an epsilon-clamped quotient
        return _safe_divide(state["mean_value"], state["weight"], zero_division=self.empty_result)


class RunningMean(_Running):
    """Mean over a running window (reference ``aggregation.py:616``).

    Example:
        >>> from torchmetrics_tpu_torch.aggregation import RunningMean
        >>> metric = RunningMean(window=2, device="cpu")
        >>> for v in (1.0, 2.0, 5.0):
        ...     metric.update(v)
        >>> float(metric.compute())  # mean of the last 2 values
        3.5
    """

    def __init__(self, window: int = 5, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__(base_metric=MeanMetric(nan_strategy=nan_strategy, **kwargs), window=window)


class RunningSum(_Running):
    """Sum over a running window (reference ``aggregation.py:673``).

    Example:
        >>> from torchmetrics_tpu_torch.aggregation import RunningSum
        >>> metric = RunningSum(window=2, device="cpu")
        >>> for v in (1.0, 2.0, 5.0):
        ...     metric.update(v)
        >>> float(metric.compute())  # sum of the last 2 values
        7.0
    """

    def __init__(self, window: int = 5, nan_strategy: Union[str, float] = "warn", **kwargs: Any) -> None:
        super().__init__(base_metric=SumMetric(nan_strategy=nan_strategy, **kwargs), window=window)
