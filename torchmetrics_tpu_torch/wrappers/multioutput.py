"""MultioutputWrapper (counterpart of ``torchmetrics_tpu/wrappers/multioutput.py``; reference
``src/torchmetrics/wrappers/multioutput.py:43``)."""
from __future__ import annotations

from typing import Any, List, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


def _get_nan_indices(*tensors: Tensor) -> Tensor:
    """Rows where any tensor has a NaN (reference ``multioutput.py:26``)."""
    if len(tensors) == 0:
        raise ValueError("Must pass at least one tensor as argument")
    nan_idxs = torch.zeros(tensors[0].shape[0], dtype=torch.bool, device=tensors[0].device)
    for t in tensors:
        nan_idxs = nan_idxs | torch.any(torch.isnan(t.reshape(t.shape[0], -1)), dim=1)
    return nan_idxs


class MultioutputWrapper(WrapperMetric):
    """Evaluate one copy of a metric per output column (reference ``multioutput.py:43``).

    Copy ``i`` gets column ``i`` of every input along ``output_dim``. With ``remove_nans`` the rows
    where any input of that column is NaN are dropped first: the number kept is read on the host, so
    the wrapper's own step stays outside any graph, and each copy's update runs on its tier as usual. With
    ``squeeze_outputs`` the column's axis is squeezed away.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import MeanSquaredError
        >>> from torchmetrics_tpu_torch.wrappers import MultioutputWrapper
        >>> metric = MultioutputWrapper(MeanSquaredError(device="cpu"), num_outputs=2)
        >>> metric.update(torch.tensor([[2.5, 0.0], [2.0, 8.0]]), torch.tensor([[3.0, -0.5], [2.0, 7.0]]))
        >>> [round(float(v), 4) for v in metric.compute()]
        [0.125, 0.625]
    """

    is_differentiable = False

    def __init__(
        self,
        base_metric: Metric,
        num_outputs: int,
        output_dim: int = -1,
        remove_nans: bool = True,
        squeeze_outputs: bool = True,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self.metrics = [base_metric.clone() for _ in range(num_outputs)]
        self.output_dim = output_dim
        self.remove_nans = remove_nans
        self.squeeze_outputs = squeeze_outputs

    def _get_args_kwargs_by_output(self, *args: Tensor, **kwargs: Tensor) -> List[Tuple[tuple, dict]]:
        """Column ``i`` of every input for copy ``i`` (reference ``multioutput.py:101-136``)."""
        args_kwargs_by_output = []
        for i in range(len(self.metrics)):
            selected_args = [a.narrow(self.output_dim, i, 1) for a in args]
            selected_kwargs = {k: v.narrow(self.output_dim, i, 1) for k, v in kwargs.items()}
            if self.remove_nans:
                tensors = [*selected_args, *selected_kwargs.values()]
                if tensors:
                    keep = torch.nonzero(~_get_nan_indices(*tensors)).squeeze(1)  # its length read on the host
                    selected_args = [a.index_select(0, keep) for a in selected_args]
                    selected_kwargs = {k: v.index_select(0, keep) for k, v in selected_kwargs.items()}
            if self.squeeze_outputs:
                selected_args = [a.squeeze(self.output_dim) for a in selected_args]
                selected_kwargs = {k: v.squeeze(self.output_dim) for k, v in selected_kwargs.items()}
            args_kwargs_by_output.append((tuple(selected_args), selected_kwargs))
        return args_kwargs_by_output

    def update(self, *args: Any, **kwargs: Any) -> None:
        args, kwargs = self._coerce(args, kwargs)
        for (selected_args, selected_kwargs), metric in zip(self._get_args_kwargs_by_output(*args, **kwargs), self.metrics):
            metric.update(*selected_args, **selected_kwargs)
        self._update_count += 1
        self._update_called = True

    def compute(self) -> Tensor:
        return torch.stack([torch.as_tensor(m.compute()) for m in self.metrics], dim=0)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        args, kwargs = self._coerce(args, kwargs)
        results = [metric(*selected_args, **selected_kwargs)
                   for (selected_args, selected_kwargs), metric in zip(self._get_args_kwargs_by_output(*args, **kwargs), self.metrics)]
        self._update_count += 1
        self._update_called = True
        if results[0] is None:
            return None
        return torch.stack(results, dim=0)

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
        super().reset()

    def _filter_kwargs(self, **kwargs: Any) -> dict:
        return self.metrics[0]._filter_kwargs(**kwargs)
