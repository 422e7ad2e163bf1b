"""Total variation (counterpart of ``torchmetrics_tpu/functional/image/tv.py``)."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor


def _total_variation_update(img: Tensor) -> Tuple[Tensor, int]:
    """Per-image sums of absolute neighbour differences, and the image count (``tv.py:10``)."""
    if img.ndim != 4:
        raise RuntimeError(f"Input `img` must be an 4D tensor, but got {tuple(img.shape)}")
    img = img.to(torch.float32)
    diff1 = img[..., 1:, :] - img[..., :-1, :]
    diff2 = img[..., :, 1:] - img[..., :, :-1]
    score = torch.sum(torch.abs(diff1), dim=(1, 2, 3)) + torch.sum(torch.abs(diff2), dim=(1, 2, 3))
    return score, img.shape[0]


def _total_variation_compute(score: Tensor, num_elements: Union[int, Tensor], reduction: Optional[str]) -> Tensor:
    """``tv.py:22``."""
    if reduction == "mean":
        return torch.sum(score) / num_elements
    if reduction == "sum":
        return torch.sum(score)
    if reduction is None or reduction == "none":
        return score
    raise ValueError("Argument `reduction` must be either 'sum', 'mean', 'none' or None")


def total_variation(img: Tensor, reduction: Optional[str] = "sum") -> Tensor:
    """Total variation (``tv.py:34``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import total_variation
        >>> print(f"{float(total_variation(torch.arange(16.0).reshape(1, 1, 4, 4))):.1f}")
        60.0
    """
    score, num_elements = _total_variation_update(img)
    return _total_variation_compute(score, num_elements, reduction)
