"""Intrinsic (data and labels) clustering scores: Calinski-Harabasz, Davies-Bouldin, Dunn
(counterpart of ``torchmetrics_tpu/functional/clustering/intrinsic.py``).

The JAX package sums each cluster's rows with a one-hot matmul (``intrinsic.py:28``). The port
sorts the rows by label and sums each cluster's run with ``torch.segment_reduce``, one thread per
run in row order (``ops/segments.sorted_segment_reduce``): bitwise repeatable, no atomics, and no
matmul whose precision a global TF32 flag could change. The cluster sizes are K1's counts.
Distances between centroids are ``(K, K)`` (``torch.cdist`` computing each difference directly, not
by the matmul expansion), where the JAX package gathers every pair's ``(d,)`` difference
(``intrinsic.py:65,83``): 1.5 GB at K = 1000 and d = 768.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.clustering.utils import (
    _validate_intrinsic_cluster_data,
    _validate_intrinsic_labels_to_samples,
    relabel,
)
from torchmetrics_tpu_torch.ops import histogram, segments
from torchmetrics_tpu_torch.utils.compute import _flushed_floor


def _cluster_stats(data: Tensor, labels_idx: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """float32 cluster sizes and centroids (``intrinsic.py:28``), with the row order that sorts the
    labels and the run bounds, which the per-sample sums reuse."""
    counts = histogram.bincount(labels_idx, k)
    order = torch.argsort(labels_idx, stable=True)
    offsets = torch.zeros(k + 1, dtype=torch.int64, device=data.device)
    offsets[1:] = torch.cumsum(counts, dim=0)
    counts = counts.to(torch.float32)
    sums = segments.sorted_segment_reduce(data[order], offsets)
    return counts, sums / torch.clamp_min(counts, 1.0)[:, None], order, offsets


def _prepare(data: Tensor, labels: Tensor) -> Tuple[Tensor, Tensor, int]:
    _validate_intrinsic_cluster_data(data, labels)
    labels_idx, k = relabel(labels)
    data = data.to(torch.float32)
    _validate_intrinsic_labels_to_samples(k, data.shape[0])
    return data, labels_idx, k


def _centroid_distances(centroids: Tensor, p: Union[int, float]) -> Tensor:
    """``(K, K)`` p-norm distances between centroids, each from its own difference."""
    return torch.cdist(centroids[None], centroids[None], p=p, compute_mode="donot_use_mm_for_euclid_dist")[0]


def calinski_harabasz_score(data: Tensor, labels: Tensor) -> Tensor:
    """Variance-ratio criterion (``intrinsic.py:37``)."""
    data, labels_idx, k = _prepare(data, labels)
    n = data.shape[0]
    counts, centroids, _, _ = _cluster_stats(data, labels_idx, k)
    mean = data.mean(dim=0)
    between = torch.sum(((centroids - mean[None, :]) ** 2).sum(dim=1) * counts)
    within = torch.sum((data - centroids[labels_idx]) ** 2)
    return torch.where(within == 0, 1.0, between * (n - k) / (_flushed_floor(within) * (k - 1.0)))


def _allclose_zero(x: Tensor) -> Tensor:
    """``jnp.allclose(x, 0.0)`` on the device: every ``|x| <= 1e-8``."""
    return torch.all(torch.abs(x) <= 1e-8)


def davies_bouldin_score(data: Tensor, labels: Tensor) -> Tensor:
    """Davies-Bouldin score (``intrinsic.py:52``)."""
    data, labels_idx, k = _prepare(data, labels)
    counts, centroids, order, offsets = _cluster_stats(data, labels_idx, k)
    dists = torch.sqrt(torch.clamp_min(((data - centroids[labels_idx]) ** 2).sum(dim=1), 0.0))
    intra = segments.sorted_segment_reduce(dists[order], offsets) / torch.clamp_min(counts, 1.0)
    centroid_distances = _centroid_distances(centroids, 2)
    degenerate = _allclose_zero(intra) | _allclose_zero(centroid_distances)
    safe_cd = torch.where(centroid_distances == 0, float("inf"), centroid_distances)
    combined = intra[None, :] + intra[:, None]
    scores = torch.max(combined / safe_cd, dim=1).values
    return torch.where(degenerate, 0.0, scores.mean())


def _dunn_index_update(data: Tensor, labels: Tensor, p: Union[int, float]) -> Tuple[Tensor, Tensor]:
    """The ``(K, K)`` centroid distances, infinite on the diagonal, and each cluster's largest
    distance of a sample to its centroid (``intrinsic.py:75``). As in the JAX package, the data is
    not validated; one cluster raises, where the JAX package's ``min`` of no pair raises."""
    labels_idx, k = relabel(labels)
    if k < 2:
        raise ValueError(f"The Dunn index needs two clusters or more to compare; got {k}.")
    data = data.to(torch.float32)
    _, centroids, _, _ = _cluster_stats(data, labels_idx, k)
    inter = _centroid_distances(centroids, p)
    inter = inter.masked_fill(torch.eye(k, dtype=torch.bool, device=inter.device), float("inf"))
    per_sample = torch.linalg.vector_norm(data - centroids[labels_idx], ord=p, dim=1)
    max_intra = segments.segment_max(per_sample, labels_idx, k)
    return inter, max_intra


def _dunn_index_compute(intercluster_distance: Tensor, max_intracluster_distance: Tensor) -> Tensor:
    """``intrinsic.py:89``."""
    return intercluster_distance.min() / max_intracluster_distance.max()


def dunn_index(data: Tensor, labels: Tensor, p: Union[int, float] = 2) -> Tensor:
    """Dunn index (``intrinsic.py:94``)."""
    inter, max_intra = _dunn_index_update(data, labels, p)
    return _dunn_index_compute(inter, max_intra)
