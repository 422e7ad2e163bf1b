"""Running wrapper (counterpart of ``torchmetrics_tpu/wrappers/running.py``; reference
``src/torchmetrics/wrappers/running.py:27``)."""
from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.metric import Metric, _merge_tensor_ladder
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


class Running(WrapperMetric):
    """Metric over a fixed-size running window of recent updates (reference ``running.py:27``).

    Keeps ``window`` copies of the wrapped metric's state (one per recent update); compute merges
    them with the base metric's reductions.
    """

    def __init__(self, base_metric: Metric, window: int = 5) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected argument `metric` to be an instance of `torchmetrics_tpu_torch.Metric` but got {base_metric}"
            )
        super().__init__(device=base_metric.device)
        if not (isinstance(window, int) and window > 0):
            raise ValueError(f"Argument `window` must be a positive integer but got {window}")
        self.base_metric = base_metric
        self.window = window
        if base_metric.full_state_update is not False:
            raise ValueError(
                f"Expected attribute `full_state_update` set to `False` but got {base_metric.full_state_update}"
            )
        self._num_vals_seen = 0
        for key, default in base_metric._defaults.items():
            for i in range(window):
                self.add_state(name=f"{key}_{i}", default=[] if isinstance(default, list) else default,
                               dist_reduce_fx=base_metric._reductions[key])

    def _save_slot(self) -> None:
        """Copy the base metric's state into the current slot, then reset the base. The copy is
        the slot's own: a base that runs on the graph tier writes its state buffers in place."""
        val = self._num_vals_seen % self.window
        base = self.base_metric
        for key in base._defaults:
            if key in base._tensors:
                self._tensors[f"{key}_{val}"] = base._tensors[key].clone()
            else:
                self._lists[f"{key}_{val}"] = list(base._lists[key])
        base.reset()
        self._num_vals_seen += 1
        self._computed = None

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update the base metric and stash its state in the current slot (reference ``running.py:106``)."""
        self.base_metric.update(*args, **kwargs)
        self._save_slot()
        self._update_count += 1
        self._update_called = True

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """The base metric's batch value; the state is stashed as in update (reference ``running.py:115``)."""
        res = self.base_metric(*args, **kwargs)
        # the base was reset after the previous slot save, so its state holds exactly this batch
        self._save_slot()
        self._update_count += 1
        self._update_called = True
        return res

    def compute(self) -> Any:
        """Merge the window's slots into the base metric and compute (reference ``running.py:126``)."""
        base = self.base_metric
        base.reset()
        for i in range(self.window):
            slot = {key: self._tensors[f"{key}_{i}"] for key in base._tensors}
            n = torch.full((), float(i + 1), dtype=torch.float32, device=self.device)
            base._tensors.update(_merge_tensor_ladder(base._tensors, slot, base._defaults, base._reductions, n))
            for key in base._lists:
                base._lists[key].extend(self._lists[f"{key}_{i}"])
        base._update_count = self.window
        if self._num_vals_seen > 0:
            base._update_called = True  # states were merged in, not update()-ed
        # an empty window keeps _update_called False so compute() warns like any fresh metric
        val = base.compute()
        base.reset()
        return val

    def reset(self) -> None:
        super().reset()
        self.base_metric.reset()
        self._num_vals_seen = 0
