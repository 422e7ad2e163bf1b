"""Small numerical helpers shared across metrics.

Counterpart of ``torchmetrics_tpu/utils/compute.py`` (``_safe_divide:21``,
``_adjust_weights_safe_divide:42``). Integer counts are divided in float32, as the JAX
package divides its float32 counts.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor


def _as_float(x: Tensor) -> Tensor:
    return x if x.is_floating_point() else x.to(torch.float32)


def _safe_divide(num: Tensor, denom: Tensor, zero_division: float = 0.0) -> Tensor:
    """Elementwise ``num / denom`` returning ``zero_division`` where ``denom == 0``.

    The denominator is patched before the division, so no inf or nan is produced.
    """
    num, denom = _as_float(num), _as_float(denom)
    zero_mask = denom == 0
    patched = torch.where(zero_mask, torch.ones_like(denom), denom)
    return torch.where(zero_mask, torch.tensor(zero_division, dtype=num.dtype, device=num.device), num / patched)


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
