"""Shared regression helpers (counterpart of ``torchmetrics_tpu/functional/regression/utils.py``).

The input checks read shapes only, never the device. The metrics run them in ``_validate``,
before any captured step; the functional entries run them before their update.
"""
from __future__ import annotations

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utils.checks import _check_same_shape


def _check_data_shape_to_num_outputs(
    preds: Tensor, target: Tensor, num_outputs: int, allow_1d_reshape: bool = False
) -> None:
    """Raise unless the shapes are ``(N,)`` (``num_outputs == 1``) or ``(N, num_outputs)`` (``utils.py:10``)."""
    if preds.ndim > 2 or target.ndim > 2:
        raise ValueError(
            f"Expected both predictions and target to be either 1- or 2-dimensional tensors,"
            f" but got {target.ndim} and {preds.ndim}."
        )
    cond1 = False
    if not allow_1d_reshape:
        cond1 = num_outputs == 1 and not (preds.ndim == 1 or preds.shape[1] == 1)
    cond2 = num_outputs > 1 and preds.ndim > 1 and num_outputs != preds.shape[1]
    if cond1 or cond2:
        raise ValueError(
            f"Argument `num_outputs` must match the second dimension of the input, but got {num_outputs}"
            f" and {tuple(preds.shape)}"
        )


def _as_float(*tensors: Tensor):
    """The inputs in float32, as the JAX package holds them with 64-bit mode off: float64 and integer
    inputs narrowed, float16 widened."""
    return tuple(t.to(torch.float32) for t in tensors)


def _num_obs(n: int, like: Tensor) -> Tensor:
    """A count as a float32 scalar on ``like``'s device: a fill, not a copy of host data, so that a
    captured step may hold it."""
    return torch.full((), float(n), dtype=torch.float32, device=like.device)


__all__ = ["_as_float", "_check_data_shape_to_num_outputs", "_check_same_shape", "_num_obs"]
