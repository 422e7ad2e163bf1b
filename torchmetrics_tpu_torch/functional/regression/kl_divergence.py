"""KL divergence (counterpart of ``torchmetrics_tpu/functional/regression/kl_divergence.py``).

The JAX package guards a zero in ``q`` with ``jnp.where(q == 0, 1e-38, q)`` (``:24``). 1e-38 is a
float32 subnormal, which XLA flushes to zero, so a zero in ``q`` where ``p > 0`` gives ``inf``
there. PyTorch keeps subnormals, on the CPU and on CUDA, so the literal would give a finite
``p * log(p / 1e-38)``. The port divides by ``q`` itself: ``p / 0`` is ``inf`` where ``p > 0``,
and ``_safe_xlogy`` gives 0 where ``p == 0``, which is the JAX package's result.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.utils import _as_float, _check_same_shape, _num_obs
from torchmetrics_tpu_torch.utils.compute import _safe_xlogy


def _check_kld_input(p: Tensor, q: Tensor) -> None:
    _check_same_shape(p, q)
    if p.ndim != 2 or q.ndim != 2:
        raise ValueError(f"Both p and q distribution must be 2D but got {p.ndim} and {q.ndim} respectively")


def _kld_update(p: Tensor, q: Tensor, log_prob: bool) -> Tuple[Tensor, Tensor]:
    """(KL of each row, number of rows) (``kl_divergence.py:13``)."""
    p, q = _as_float(p, q)
    if log_prob:
        measures = torch.sum(torch.exp(p) * (p - q), dim=-1)
    else:
        p = p / torch.sum(p, dim=-1, keepdim=True)
        q = q / torch.sum(q, dim=-1, keepdim=True)
        measures = torch.sum(_safe_xlogy(p, p / q), dim=-1)
    return measures, _num_obs(p.shape[0], p)


def _kld_compute(measures: Tensor, total: Tensor, reduction: Optional[str] = "mean") -> Tensor:
    if reduction == "sum":
        return torch.sum(measures)
    if reduction == "mean":
        return torch.sum(measures) / total
    if reduction in ("none", None):
        return measures
    raise ValueError(f"Expected reduction to be one of `['mean', 'sum', 'none', None]` but got {reduction}")


def kl_divergence(p: Tensor, q: Tensor, log_prob: bool = False, reduction: Optional[str] = "mean") -> Tensor:
    """KL(P||Q) (``kl_divergence.py:38``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import kl_divergence
        >>> p, q = torch.tensor([[0.5, 0.5], [0.8, 0.2]]), torch.tensor([[0.4, 0.6], [0.6, 0.4]])
        >>> print(f"{float(kl_divergence(p, q)):.4f}")
        0.0560
    """
    _check_kld_input(p, q)
    measures, total = _kld_update(p, q, log_prob)
    return _kld_compute(measures, total, reduction)
