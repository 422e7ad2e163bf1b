"""Fleiss' kappa (counterpart of ``torchmetrics_tpu/functional/nominal/fleiss_kappa.py``)."""
from __future__ import annotations

from typing import Literal

import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops import histogram


def _fleiss_kappa_update(ratings: Tensor, mode: Literal["counts", "probs"] = "counts") -> Tensor:
    """``(n_samples, n_categories)`` counts (``fleiss_kappa.py:11``). In ``probs`` mode each rater's
    argmax category is counted per subject by one K1 bincount of ``row * C + category``, exact in
    int32 (the JAX package sums a float32 one-hot)."""
    if mode == "probs":
        if ratings.dim() != 3 or not ratings.is_floating_point():
            raise ValueError(
                "If argument ``mode`` is 'probs', ratings must have 3 dimensions with the format"
                " [n_samples, n_categories, n_raters] and be floating point."
            )
        n_samples, n_categories = ratings.shape[0], ratings.shape[1]
        picked = torch.argmax(ratings, dim=1)  # (n_samples, n_raters)
        rows = torch.arange(n_samples, device=ratings.device)[:, None]
        fused = rows * n_categories + picked
        return histogram.bincount(fused, n_samples * n_categories).reshape(n_samples, n_categories)
    if mode == "counts" and (ratings.dim() != 2 or ratings.is_floating_point()):
        raise ValueError(
            "If argument ``mode`` is `counts`, ratings must have 2 dimensions with the format"
            " [n_samples, n_categories] and be none floating point."
        )
    return ratings


def _fleiss_kappa_compute(counts: Tensor) -> Tensor:
    """Kappa from the counts (``fleiss_kappa.py:32``), in float32."""
    counts = counts.to(torch.float32)
    total = counts.shape[0]
    num_raters = counts.sum(dim=1).max()
    p_i = counts.sum(dim=0) / (total * num_raters)
    p_j = ((counts**2).sum(dim=1) - num_raters) / (num_raters * (num_raters - 1))
    p_bar = p_j.mean()
    pe_bar = (p_i**2).sum()
    return (p_bar - pe_bar) / (1 - pe_bar + 1e-5)


def fleiss_kappa(ratings: Tensor, mode: Literal["counts", "probs"] = "counts") -> Tensor:
    """Fleiss' kappa (``fleiss_kappa.py:44``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import fleiss_kappa
        >>> ratings = torch.tensor([[3, 2, 5], [4, 4, 2], [5, 3, 2]])
        >>> print(f"{float(fleiss_kappa(ratings, mode='counts')):.4f}")
        -0.0550
    """
    if mode not in ("counts", "probs"):
        raise ValueError("Argument ``mode`` must be one of 'counts' or 'probs'.")
    return _fleiss_kappa_compute(_fleiss_kappa_update(ratings, mode))
