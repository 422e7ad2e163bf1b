"""What the regression metrics share: the ``num_outputs`` check, the shape check of ``_validate``,
and state that takes the width of its first multi-output batch.

``R2Score``, ``RelativeSquaredError`` (with ``num_outputs=1``) and ``ExplainedVariance`` keep
scalar moment sums, as the JAX package does, and a batch of ``(N, d)`` inputs broadcasts them to
``(d,)`` there (``regression/r2.py:56-67``, ``explained_variance.py:46-55``). A captured step
writes its state into buffers of fixed shape, so the port widens those states before the step,
in ``_validate``: each scalar sum becomes ``d`` copies of itself, the value the JAX package's
broadcast gives, and the next graph step captures with the wider buffers. ``reset`` restores the
scalar defaults, as in JAX.
"""
from __future__ import annotations

from typing import Tuple

from torch import Tensor

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.checks import _check_same_shape


def _check_num_outputs(num_outputs: int, what: str = "a positive integer") -> None:
    if not (isinstance(num_outputs, int) and num_outputs > 0):
        raise ValueError(f"Argument `num_outputs` must be {what}, but got {num_outputs}")


class _SameShape(Metric):
    """A metric whose inputs must have the same shape: checked in ``_validate``, before any graph."""

    def _validate(self, preds, target) -> None:
        _check_same_shape(preds, target)


class _ColumnStates(Metric):
    #: the states kept per output column
    _column_states: Tuple[str, ...] = ()

    def _widen_states(self, preds: Tensor) -> None:
        if preds.ndim != 2 or preds.shape[1] == 1:
            return
        tensors = self._state.tensors
        for name in self._column_states:
            if tensors[name].ndim == 0:
                tensors[name] = tensors[name].expand(preds.shape[1]).clone()
