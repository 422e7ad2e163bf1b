"""Small numerical helpers shared across metrics.

Counterpart of ``torchmetrics_tpu/utils/compute.py`` (``_safe_divide:21``, ``_safe_xlogy:34``,
``_adjust_weights_safe_divide:42``, ``_auc_compute_without_check:59``, ``_auc_compute:66``,
``normalize_logits_if_needed:84``), and ``_flushed_floor``, the JAX package's ``jnp.maximum(x, 1e-38)``
guards as XLA runs them. Integer counts are divided in float32, as the JAX
package divides its float32 counts.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor


def _as_float(x: Tensor) -> Tensor:
    return x if x.is_floating_point() else x.to(torch.float32)


def _flushed_floor(x: Tensor) -> Tensor:
    """The JAX package's divide-by-zero guard ``jnp.maximum(x, 1e-38)`` as XLA computes it.

    1e-38 is a float32 subnormal, and XLA flushes subnormals to zero, so the guard is ``max(x, 0)``:
    a count of zero stays zero and ``0 / 0`` is NaN, as in the reference's plain division. PyTorch
    keeps subnormals, on the CPU and on the card, so ``clamp_min(x, 1e-38)`` would turn that NaN into
    0 (``ROADMAP.md`` queue C, C3). Where a ``where`` masks the quotient, the value is the same either
    way.
    """
    return torch.clamp_min(_as_float(x), 0.0)


def _safe_divide(num: Tensor, denom: Tensor, zero_division: float = 0.0) -> Tensor:
    """Elementwise ``num / denom`` returning ``zero_division`` where ``denom == 0``.

    The denominator is patched before the division, so no inf or nan is produced. Both patches
    take a Python scalar (``masked_fill``): no host-to-device copy and no fill of a full tensor, so
    the call can be captured in a CUDA graph.
    """
    num, denom = _as_float(num), _as_float(denom)
    zero_mask = denom == 0
    return (num / denom.masked_fill(zero_mask, 1.0)).masked_fill_(zero_mask, float(zero_division))


def _safe_xlogy(x: Tensor, y: Tensor) -> Tensor:
    """``x * log(y)``, 0 where ``x == 0`` even where ``y == 0`` (``compute.py:34``)."""
    zero = x == 0
    return torch.where(zero, 0.0, x * torch.log(torch.where(zero, 1.0, y)))


def _adjust_weights_safe_divide(
    score: Tensor, average: Optional[str], multilabel: bool, tp: Tensor, fp: Tensor, fn: Tensor,
    top_k: int = 1,
) -> Tensor:
    """Apply the macro/weighted reduction of a per-class ``score``."""
    if average is None or average == "none":
        return score
    if average == "weighted":
        weights = (tp + fn).to(score.dtype)
    else:
        weights = torch.ones_like(score)
        if not multilabel:
            zero = (tp + fp + fn == 0) if top_k == 1 else (tp + fn == 0)
            weights = torch.where(zero, torch.zeros_like(weights), weights)
    return _safe_divide(torch.sum(weights * score, dim=-1), torch.sum(weights, dim=-1))


def _auc_compute_without_check(x: Tensor, y: Tensor, direction: float, axis: int = -1) -> Tensor:
    """Trapezoidal area under ``(x, y)`` along ``axis``; ``direction`` flips the sign for descending x
    (``compute.py:59``)."""
    dx = torch.diff(x, dim=axis)
    n = y.shape[axis]
    y_avg = (y.narrow(axis, 1, n - 1) + y.narrow(axis, 0, n - 1)) / 2.0
    return torch.sum(dx * y_avg, dim=axis) * direction


def _auc_compute(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    """Area under ``y = f(x)``, sorting by ``x`` first when ``reorder`` (``compute.py:66``)."""
    if reorder:
        order = torch.argsort(x)
        x, y = x[order], y[order]
    return _auc_compute_without_check(x, y, 1.0)


def normalize_logits_if_needed(preds: Tensor, normalization: str = "sigmoid") -> Tensor:
    """Apply sigmoid, or softmax along the last axis, only when ``preds`` is not already a
    probability (``compute.py:84``).

    The JAX package picks the branch with ``lax.cond`` on a device predicate. Here the predicate
    stays on the device too and ``torch.where`` picks the result, so no update waits for a read
    of the device; the price is that the transcendental pass always runs.
    """
    if not preds.is_floating_point() or preds.numel() == 0:
        return preds
    lo, hi = torch.aminmax(preds)
    outside = (lo < 0) | (hi > 1)
    normalized = torch.sigmoid(preds) if normalization == "sigmoid" else torch.softmax(preds, dim=-1)
    return torch.where(outside, normalized, preds)
