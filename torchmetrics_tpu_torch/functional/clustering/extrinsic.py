"""Extrinsic (label against label) clustering scores (counterpart of
``torchmetrics_tpu/functional/clustering/extrinsic.py``).

Every score is a masked reduction over one contingency table (K1's exact counts), in float32 as in
the JAX package, with one exception: the expected mutual information, whose terms are summed in
float64 (``ROADMAP.md`` queue C, "Differences the port keeps on purpose"). The JAX package sums
nine ``gammaln`` terms of about ``lgamma(n + 1)`` in float32 (``extrinsic.py:142-152``), so at a
million samples each term carries an error near 1.0 and ``exp`` of their sum, a number near -10,
is off by up to a factor e: at n = 1,000,000 and 100 clusters its EMI is 3.6 times float64's.
"""
from __future__ import annotations

import math
from typing import Literal, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.clustering.utils import (
    _validate_average_method_arg,
    calculate_contingency_matrix,
    calculate_generalized_mean,
    calculate_pair_cluster_confusion_matrix,
    check_cluster_labels,
)
from torchmetrics_tpu_torch.utils.compute import _flushed_floor

#: ``(i, j, nij)`` terms of the expected mutual information summed per pass: about 4M, as the JAX
#: package's grid chunk (``extrinsic.py:158``); about a dozen 8-byte temporaries a term, 0.4 GB
EMI_CHUNK_TERMS = 1 << 22
_EPS32 = torch.finfo(torch.float32).eps


def _scalar(value: float, like: Tensor) -> Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _entropy_from_marginal(counts: Tensor) -> Tensor:
    """Entropy of a label distribution from its count vector, a contingency marginal (``extrinsic.py:31``).

    After relabelling every marginal count is positive, so this equals ``calculate_entropy`` of the
    raw labels without relabelling them again.
    """
    counts = counts.to(torch.float32)
    if counts.shape[0] <= 1:
        return _scalar(0.0, counts)
    n = counts.sum()
    safe = _flushed_floor(counts)
    return -torch.sum((counts / n) * (torch.log(safe) - torch.log(n)))


def _mutual_info_from_contingency(contingency: Tensor) -> Tensor:
    """MI from a contingency table (``extrinsic.py:45``): the empty cells masked, not gathered."""
    contingency = contingency.to(torch.float32)
    if contingency.shape[0] == 1 or contingency.shape[1] == 1:  # a single cluster on either side
        return _scalar(0.0, contingency)
    n = contingency.sum()
    u = contingency.sum(dim=1)
    v = contingency.sum(dim=0)
    pos = contingency > 0
    safe = torch.where(pos, contingency, 1.0)
    log_outer = torch.log(_flushed_floor(u))[:, None] + torch.log(_flushed_floor(v))[None, :]
    terms = safe / n * (torch.log(n) + torch.log(safe) - log_outer)
    return torch.sum(torch.where(pos, terms, 0.0))


def mutual_info_score(preds: Tensor, target: Tensor) -> Tensor:
    """Mutual information between two clusterings (``extrinsic.py:60``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import mutual_info_score
        >>> preds = torch.tensor([0, 0, 1, 1, 2])
        >>> target = torch.tensor([0, 0, 1, 2, 2])
        >>> print(f"{float(mutual_info_score(preds, target)):.4f}")
        0.7777
    """
    check_cluster_labels(preds, target)
    return _mutual_info_from_contingency(calculate_contingency_matrix(preds, target))


def rand_score(preds: Tensor, target: Tensor) -> Tensor:
    """Rand score (``extrinsic.py:75``)."""
    check_cluster_labels(preds, target)
    pair = calculate_pair_cluster_confusion_matrix(contingency=calculate_contingency_matrix(preds, target))
    numerator = pair[0, 0] + pair[1, 1]
    denominator = pair.sum()
    return torch.where((numerator == denominator) | (denominator == 0), 1.0,
                       numerator / _flushed_floor(denominator))


def adjusted_rand_score(preds: Tensor, target: Tensor) -> Tensor:
    """Adjusted Rand score (``extrinsic.py:96``)."""
    check_cluster_labels(preds, target)
    pair = calculate_pair_cluster_confusion_matrix(contingency=calculate_contingency_matrix(preds, target))
    tn, fp, fn, tp = pair[0, 0], pair[0, 1], pair[1, 0], pair[1, 1]
    denom = (tp + fn) * (fn + tn) + (tp + fp) * (fp + tn)
    return torch.where((fn == 0) & (fp == 0), 1.0, 2.0 * (tp * tn - fn * fp) / _flushed_floor(denom))


def expected_mutual_info_score(contingency: Tensor, n_samples: int) -> Tensor:
    """Expected MI under the hypergeometric null (``extrinsic.py:117``), summed in float64 and
    returned as float32.

    For row and column sums ``a_i``, ``b_j`` and ``n`` samples, the sum runs over every cell and
    every ``nij`` in its valid range ``max(1, a_i + b_j - n) <= nij <= min(a_i, b_j)``, and no
    other: the terms are numbered cell by cell, and each pass of :data:`EMI_CHUNK_TERMS` terms finds
    its cells by a binary search over the running ends. Every ``gammaln`` term is read by integer
    index from one float64 table of ``lgamma(k + 1)`` for ``k = 0..n`` (8 MB at n = 10^6). The
    total number of terms is read back to the host once.
    """
    a = contingency.sum(dim=1, dtype=torch.int64)
    b = contingency.sum(dim=0, dtype=torch.int64)
    if a.shape[0] == 1 or b.shape[0] == 1:
        return _scalar(0.0, contingency)
    device, f64 = contingency.device, torch.float64
    n = int(n_samples)
    lg = torch.lgamma(torch.arange(1, n + 2, dtype=f64, device=device))  # lg[k] = log(k!)
    ai = a[:, None].expand(a.shape[0], b.shape[0]).reshape(-1)
    bj = b[None, :].expand(a.shape[0], b.shape[0]).reshape(-1)
    lo = torch.clamp_min(ai + bj - n, 1)
    count = torch.clamp_min(torch.minimum(ai, bj) - lo + 1, 0)
    ends = torch.cumsum(count, dim=0)
    total = int(ends[-1])
    # what does not depend on nij, per cell: nij of term t is base[cell] + t
    base = lo - (ends - count)
    cell_gln = lg[ai] + lg[bj] + lg[n - ai] + lg[n - bj] - lg[n]
    cell_log = math.log(n) - torch.log(ai.to(f64)) - torch.log(bj.to(f64))
    emi = torch.zeros((), dtype=f64, device=device)
    for start in range(0, total, EMI_CHUNK_TERMS):
        t = torch.arange(start, min(start + EMI_CHUNK_TERMS, total), device=device)
        cell = torch.searchsorted(ends, t, right=True)
        nij = base[cell] + t
        a_c, b_c = ai[cell], bj[cell]
        gln = cell_gln[cell] - lg[nij] - lg[a_c - nij] - lg[b_c - nij] - lg[n - a_c - b_c + nij]
        nf = nij.to(f64)
        emi += torch.sum(nf / n * (cell_log[cell] + torch.log(nf)) * torch.exp(gln))
    return emi.to(torch.float32)


def _normalizer(contingency: Tensor, average_method: str) -> Tensor:
    entropies = torch.stack([_entropy_from_marginal(contingency.sum(dim=0)), _entropy_from_marginal(contingency.sum(dim=1))])
    return calculate_generalized_mean(entropies, average_method)


def adjusted_mutual_info_score(
    preds: Tensor, target: Tensor, average_method: Literal["min", "geometric", "arithmetic", "max"] = "arithmetic"
) -> Tensor:
    """Adjusted mutual information (``extrinsic.py:167``), with the float64 EMI of
    :func:`expected_mutual_info_score`.

    Two labelings that are the same partition into more than one cluster (every row and every
    column of the contingency table holds one nonzero cell) score exactly 1, as scikit-learn and
    the JAX package score them: their MI equals both entropies, so the score is ``(H - EMI) / (H -
    EMI)``. Where every label is a singleton, EMI equals H as well, so both sides are rounding noise:
    the JAX package's float32 EMI misses H by a few units in the last place and scores 1, while the
    port's float64 EMI rounds to H exactly and the plain formula would give 0 / 0 (``ROADMAP.md``
    queue C, C4).
    """
    _validate_average_method_arg(average_method)
    check_cluster_labels(preds, target)
    contingency = calculate_contingency_matrix(preds, target)
    mutual_info = _mutual_info_from_contingency(contingency)
    emi = expected_mutual_info_score(contingency, target.shape[0])
    denominator = _normalizer(contingency, average_method) - emi
    denominator = torch.where(denominator < 0, torch.clamp_max(denominator, -_EPS32), torch.clamp_min(denominator, _EPS32))
    ami = (mutual_info - emi) / denominator
    if contingency.shape[0] == 1 or contingency.shape[1] == 1:
        return ami
    nonzero = contingency > 0
    same_partition = torch.all(nonzero.sum(dim=0) == 1) & torch.all(nonzero.sum(dim=1) == 1)
    return torch.where(same_partition, 1.0, ami)


def normalized_mutual_info_score(
    preds: Tensor, target: Tensor, average_method: Literal["min", "geometric", "arithmetic", "max"] = "arithmetic"
) -> Tensor:
    """Normalized mutual information (``extrinsic.py:198``); an MI within float32's epsilon of 0 is
    returned as it is, a read of the device as in the JAX package."""
    check_cluster_labels(preds, target)
    _validate_average_method_arg(average_method)
    contingency = calculate_contingency_matrix(preds, target)
    mutual_info = _mutual_info_from_contingency(contingency)
    if float(torch.abs(mutual_info)) <= _EPS32:
        return mutual_info
    return mutual_info / _normalizer(contingency, average_method)


def fowlkes_mallows_index(preds: Tensor, target: Tensor) -> Tensor:
    """Fowlkes-Mallows index (``extrinsic.py:226``). The three sums of squared counts are exact in
    int64; the ratio is float32."""
    check_cluster_labels(preds, target)
    contingency = calculate_contingency_matrix(preds, target).to(torch.int64)
    n = preds.shape[0]
    tk = (torch.sum(contingency**2) - n).to(torch.float32)
    pk = (torch.sum(contingency.sum(dim=0) ** 2) - n).to(torch.float32)
    qk = (torch.sum(contingency.sum(dim=1) ** 2) - n).to(torch.float32)
    fm = torch.sqrt(tk / _flushed_floor(pk)) * torch.sqrt(tk / _flushed_floor(qk))
    return torch.where(torch.abs(tk) < 1e-8, 0.0, fm)


def _homogeneity_score_compute(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(homogeneity, MI, H(preds), H(target)) (``extrinsic.py:247``): one contingency table, whose
    marginals give both entropies."""
    check_cluster_labels(preds, target)
    if target.shape[0] == 0:
        zero = _scalar(0.0, target)
        return zero, zero, zero, zero
    contingency = calculate_contingency_matrix(preds, target)
    entropy_target = _entropy_from_marginal(contingency.sum(dim=1))
    entropy_preds = _entropy_from_marginal(contingency.sum(dim=0))
    mutual_info = _mutual_info_from_contingency(contingency)
    homogeneity = torch.where(entropy_target > 0, mutual_info / _flushed_floor(entropy_target), 1.0)
    return homogeneity, mutual_info, entropy_preds, entropy_target


def _completeness(mutual_info: Tensor, entropy_preds: Tensor) -> Tensor:
    return torch.where(entropy_preds > 0, mutual_info / _flushed_floor(entropy_preds), 1.0)


def homogeneity_score(preds: Tensor, target: Tensor) -> Tensor:
    """Homogeneity (``extrinsic.py:260``)."""
    return _homogeneity_score_compute(preds, target)[0]


def completeness_score(preds: Tensor, target: Tensor) -> Tensor:
    """Completeness (``extrinsic.py:274``)."""
    _, mutual_info, entropy_preds, _ = _homogeneity_score_compute(preds, target)
    return _completeness(mutual_info, entropy_preds)


def v_measure_score(preds: Tensor, target: Tensor, beta: Union[int, float] = 1.0) -> Tensor:
    """V-measure (``extrinsic.py:289``)."""
    homogeneity, mutual_info, entropy_preds, _ = _homogeneity_score_compute(preds, target)
    completeness = _completeness(mutual_info, entropy_preds)
    numerator = (1 + beta) * homogeneity * completeness
    denominator = beta * homogeneity + completeness
    return torch.where(denominator > 0, numerator / _flushed_floor(denominator), 0.0)
