"""Streaming threshold-histogram accumulator for the curve family (counterpart of
``torchmetrics_tpu/sketch/hist.py``).

Exact mode keeps every ``(score, label, weight)`` triple and sorts at compute. The sketch keeps two
fixed ``(bins,)`` float32 histograms instead, positive and negative mass per score bucket, from
which the binned curve family reconstructs at compute by suffix sums. For the uniform grid
``thr_t = t / (bins - 1)`` (``_adjust_threshold_arg(bins)``),

    ``floor(s·(bins-1)) >= t  <=>  s >= thr_t``,

so the suffix sum of the histogram from bucket ``t`` is the threshold count ``Σ w·[s >= thr_t]``:
sketch mode equals binned mode over the implicit ``linspace(0, 1, bins)`` grid. The curve classes
fold a batch in with one launch of kernel K2's fused entry
(:func:`torchmetrics_tpu_torch.ops.hist_pair.sketch_update`), which buckets, weighs and adds to
the old state itself; :func:`hist_update_pair` and :func:`hist_update_classes` are the JAX
package's functions of those names, each one ``hist_pair`` launch beside the elementwise steps.
Merge is an elementwise sum, so the states register with ``dist_reduce_fx="sum"``. Counts are
float32: exact to 2^24 per bucket.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops.hist_pair import score_bucket
from torchmetrics_tpu_torch.ops.histogram import hist_pair

DEFAULT_BINS = 2048


def hist_init(bins: int = DEFAULT_BINS, classes: Optional[int] = None) -> Tensor:
    """Empty histogram state: ``(bins,)``, or ``(classes, bins)``, float32 zeros."""
    if bins < 2:
        raise ValueError(f"sketch bins must be >= 2, got {bins}")
    shape = (bins,) if classes is None else (classes, bins)
    return torch.zeros(shape, dtype=torch.float32)


def hist_update_pair(
    pos_hist: Tensor, neg_hist: Tensor, scores: Tensor, pos_w: Tensor, neg_w: Tensor
) -> Tuple[Tensor, Tensor]:
    """Fold one batch of flat ``(N,)`` scores and weights into the (pos, neg) histograms: one K2 launch."""
    idx = score_bucket(scores, pos_hist.shape[-1])
    dp, dn = hist_pair(idx, pos_w, neg_w, pos_hist.numel())
    return pos_hist + dp.reshape(pos_hist.shape), neg_hist + dn.reshape(neg_hist.shape)


def class_bucket(scores: Tensor, bins: int) -> Tensor:
    """Fused (class, bucket) index ``c·bins + bucket`` of ``(N, C)`` scores, flattened: one
    histogram of ``C·bins`` bins holds the whole per-class table."""
    offsets = torch.arange(scores.shape[1], dtype=torch.int32, device=scores.device)[None, :] * bins
    return (score_bucket(scores, bins) + offsets).reshape(-1)


def hist_update_classes(
    pos_hist: Tensor, neg_hist: Tensor, scores: Tensor, pos_w: Tensor, neg_w: Tensor
) -> Tuple[Tensor, Tensor]:
    """Per-class twin of :func:`hist_update_pair`: scores and weights ``(N, C)``, histograms
    ``(C, bins)``; still one K2 launch, over the fused (class, bucket) index."""
    c, bins = pos_hist.shape
    dp, dn = hist_pair(class_bucket(scores, bins), pos_w.reshape(-1), neg_w.reshape(-1), c * bins)
    return pos_hist + dp.reshape(c, bins), neg_hist + dn.reshape(c, bins)


def suffix_counts(hist: Tensor) -> Tensor:
    """``out[..., t] = Σ_{b >= t} hist[..., b]``: the threshold counts."""
    return torch.flip(torch.cumsum(torch.flip(hist, dims=(-1,)), dim=-1), dims=(-1,))


def hist_threshold_counts(pos_hist: Tensor, neg_hist: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``(tp, fp, tn, fn)``, each ``(..., bins)``, at the implicit uniform threshold grid."""
    tp = suffix_counts(pos_hist)
    fp = suffix_counts(neg_hist)
    total_p = tp[..., :1]  # the suffix sum at t = 0 is the total mass
    total_n = fp[..., :1]
    return tp, fp, total_n - fp, total_p - tp


def auroc_error_bound(bins: int) -> float:
    """Documented |ΔAUROC| bound against exact mode (``sketch/hist.py:103``).

    The binned curve points are exact points of the true ROC curve; the error is the trapezoid
    gap between consecutive grid points, O(1/bins) for score distributions that do not put a
    large class mass inside one bucket. The factor 4 covers the seeded workloads with margin.
    """
    return 4.0 / bins


def hist_state_bytes(bins: int = DEFAULT_BINS, classes: Optional[int] = None) -> int:
    """Fixed footprint of the (pos, neg) histogram pair in bytes (float32)."""
    return 2 * bins * (classes or 1) * 4
