"""Levenshtein edit distance between character sequences (counterpart of
``torchmetrics_tpu/functional/text/edit.py``, reference ``functional/text/edit.py``)."""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text._edit import edit_distance_batch


def _edit_distance_update(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    substitution_cost: int = 1,
    device: Union[str, torch.device, None] = None,
) -> Tensor:
    """Per-pair distances, int32 on the device (``edit.py:13``), through the batched row scan."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    if not all(isinstance(x, str) for x in preds):
        raise ValueError(f"All values in argument `preds` must be strings, but got {preds}")
    if not all(isinstance(x, str) for x in target):
        raise ValueError(f"All values in argument `target` must be strings, but got {target}")
    if len(preds) != len(target):
        raise ValueError(
            f"Expected argument `preds` and `target` to have same length, but got {len(preds)} and {len(target)}"
        )
    d = edit_distance_batch([list(p) for p in preds], [list(t) for t in target], float(substitution_cost), device)
    return d.to(torch.int32)


def _edit_distance_compute(
    edit_scores: Tensor,
    num_elements: Union[Tensor, int],
    reduction: Optional[str] = "mean",
) -> Tensor:
    """Batch reduction (``edit.py:35``): int32 sums, as JAX's."""
    if edit_scores.numel() == 0:
        return torch.zeros((), dtype=torch.int32, device=edit_scores.device)
    if reduction == "mean":
        return torch.sum(edit_scores, dtype=edit_scores.dtype) / num_elements
    if reduction == "sum":
        return torch.sum(edit_scores, dtype=edit_scores.dtype)
    if reduction is None or reduction == "none":
        return edit_scores
    raise ValueError("Argument `reduction` must be either 'sum', 'mean', 'none' or None")


def edit_distance(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    substitution_cost: int = 1,
    reduction: Optional[str] = "mean",
    device: Union[str, torch.device, None] = None,
) -> Tensor:
    """Levenshtein edit distance (``edit.py:51``), on ``device`` (CUDA unless named).

    Example:
        >>> from torchmetrics_tpu_torch.functional import edit_distance
        >>> print(f"{float(edit_distance(['kitten'], ['sitting'], device='cpu')):.4f}")
        3.0000
    """
    distance = _edit_distance_update(preds, target, substitution_cost, device)
    return _edit_distance_compute(distance, num_elements=distance.numel(), reduction=reduction)
