"""Masked single-query retrieval kernels (counterpart of ``torchmetrics_tpu/functional/retrieval/_kernels.py``).

Every kernel takes ``(preds, target, mask)`` of shape ``(..., L)`` and returns one value per row:
a row is one query, and positions with ``mask == 0`` (padding, ignored documents) count nowhere.
The JAX package writes them for one query and ``vmap``s them over a padded ``(Q, L_max)`` batch;
here they are written batched over the last dimension, so one call serves one query (the
functional entries) or every row of the rectangle (``retrieval/base.py``).

Tie order: ``_ranked_target`` sorts the scores ascending, stably, and reverses, so equal scores
come out in reversed input order, as ``jnp.argsort(...)[::-1]`` gives them. The sort runs on the
integer image of the scores (:func:`sortable`), which orders ``-0.0`` equal to ``+0.0`` and every
NaN after ``+inf``, as ``lax.sort`` does, on both devices.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops.segments import segment_offsets, sorted_segment_reduce
from torchmetrics_tpu_torch.utils.compute import _flushed_floor

_NEG = -1e30  # effective -inf for masked score positions


def sortable(x: Tensor) -> Tensor:
    """int32 keys whose ascending order is the ascending order of the float32 values ``x`` under
    ``lax.sort``'s total order: ``-0.0`` and ``+0.0`` equal, NaN (of either sign) after ``+inf``."""
    x = x.to(torch.float32)
    x = torch.where(torch.isnan(x), float("nan"), x + 0.0)  # -0.0 + 0.0 is +0.0
    bits = x.view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _order_desc(scores: Tensor) -> Tensor:
    """Indices of ``scores`` along the last dimension in descending order, ties in reversed input
    order: a stable ascending sort, reversed (``jnp.argsort(scores)[::-1]``)."""
    return torch.sort(sortable(scores), dim=-1, stable=True).indices.flip(-1)


def _ranked(preds: Tensor, mask: Tensor) -> Tensor:
    return _order_desc(torch.where(mask > 0, preds, _NEG))


def _ranked_target(preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    """Relevance values sorted by descending score (masked entries last)."""
    return torch.gather(target * mask, -1, _ranked(preds, mask))


def _positions(like: Tensor) -> Tensor:
    """1-based ranks ``1..L`` as float32."""
    return torch.arange(1, like.shape[-1] + 1, dtype=torch.float32, device=like.device)


def _effective_k(top_k: Optional[int], mask: Tensor) -> Tensor:
    """k limited to the number of valid docs (None = all valid docs), one per row, shape ``(..., 1)``."""
    n = mask.sum(-1, keepdim=True)
    return n if top_k is None else torch.clamp_max(n, float(top_k))


def average_precision_kernel(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    """AP = mean over relevant docs of precision@rank (reference ``average_precision.py``)."""
    rel = _ranked_target(preds, target, mask)
    pos = _positions(rel)
    in_k = pos <= _effective_k(top_k, mask)
    prec_at_rank = torch.cumsum(rel, -1) / pos
    n_rel = (rel * in_k).sum(-1)
    return torch.where(n_rel > 0, (prec_at_rank * rel * in_k).sum(-1) / torch.clamp_min(n_rel, 1.0), 0.0)


def reciprocal_rank_kernel(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    """MRR contribution: 1/rank of the first relevant document."""
    rel = _ranked_target(preds, target, mask)
    pos = _positions(rel)
    in_k = pos <= _effective_k(top_k, mask)
    first = torch.where((rel > 0) & in_k, pos, float("inf")).amin(-1)
    return torch.where(torch.isfinite(first), 1.0 / torch.clamp_min(first, 1.0), 0.0)


def precision_kernel(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None,
                     adaptive_k: bool = False) -> Tensor:
    """precision@k (reference ``precision.py``): relevant-in-top-k / k."""
    rel = _ranked_target(preds, target, mask)
    pos = _positions(rel)
    n = mask.sum(-1, keepdim=True)
    if top_k is None or adaptive_k:
        k = _effective_k(top_k, mask)
    else:
        k = torch.full_like(n, float(top_k))
    in_k = pos <= torch.minimum(k, n)
    hits = (rel * in_k).sum(-1)
    return torch.where((target * mask).sum(-1) > 0, hits / torch.clamp_min(k[..., 0], 1.0), 0.0)


def recall_kernel(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    """recall@k: relevant-in-top-k / total relevant."""
    rel = _ranked_target(preds, target, mask)
    in_k = _positions(rel) <= _effective_k(top_k, mask)
    total_rel = (target * mask).sum(-1)
    return torch.where(total_rel > 0, (rel * in_k).sum(-1) / torch.clamp_min(total_rel, 1.0), 0.0)


def fall_out_kernel(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    """fall-out@k: irrelevant-in-top-k / total irrelevant."""
    order = _ranked(preds, mask)
    rel = torch.gather(target * mask, -1, order)
    in_k = _positions(rel) <= _effective_k(top_k, mask)
    # irrelevant indicator among the ranked valid docs: ranked mask minus ranked relevance
    irrel = torch.gather(mask, -1, order) - rel
    total_irrel = mask.sum(-1) - (target * mask).sum(-1)
    return torch.where(total_irrel > 0, (irrel * in_k).sum(-1) / torch.clamp_min(total_irrel, 1.0), 0.0)


def hit_rate_kernel(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    """hit-rate@k: 1 if any relevant doc is in the top k."""
    rel = _ranked_target(preds, target, mask)
    in_k = _positions(rel) <= _effective_k(top_k, mask)
    return ((rel * in_k).sum(-1) > 0).to(torch.float32)


def r_precision_kernel(preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    """R-precision: relevant-in-top-R / R, with R = number of relevant docs."""
    rel = _ranked_target(preds, target, mask)
    r = (target * mask).sum(-1)
    in_r = _positions(rel) <= r[..., None]
    return torch.where(r > 0, (rel * in_r).sum(-1) / torch.clamp_min(r, 1.0), 0.0)


def ndcg_kernel(preds: Tensor, target: Tensor, mask: Tensor, top_k: Optional[int] = None) -> Tensor:
    """NDCG@k with tie-averaged DCG (sklearn semantics, reference ``ndcg.py``).

    Graded relevance is allowed: gain = target value, discount = 1/log2(rank + 1). The docs of a
    tie group share the mean discount of the group's positions; the groups are consecutive in the
    ranked row, so their sums are sorted-segment reductions over the flattened rows.
    """
    length = preds.shape[-1]
    pos = torch.arange(length, dtype=torch.float32, device=preds.device)
    k = _effective_k(top_k, mask)
    discount = torch.where(pos < k, 1.0 / torch.log2(pos + 2.0), 0.0)

    scores = torch.where(mask > 0, preds, _NEG)
    order = _order_desc(scores)
    s_sorted = torch.gather(scores, -1, order)
    t_sorted = torch.gather(target * mask, -1, order)
    first = torch.ones(s_sorted.shape[:-1] + (1,), dtype=torch.bool, device=preds.device)
    is_new = torch.cat([first, s_sorted[..., 1:] != s_sorted[..., :-1]], -1)
    group_id = torch.cumsum(is_new, -1) - 1
    # one id space over every row: rows stay apart, and the ids stay sorted
    rows = torch.arange(group_id.numel() // length, device=preds.device).reshape(group_id.shape[:-1] + (1,))
    flat_id = (group_id + rows * length).reshape(-1)
    bounds = segment_offsets(flat_id, flat_id.numel())
    group_disc = sorted_segment_reduce(discount.expand(is_new.shape).reshape(-1), bounds)
    group_cnt = (bounds[1:] - bounds[:-1]).to(torch.float32)
    avg_disc = (group_disc / torch.clamp_min(group_cnt, 1.0))[flat_id].reshape(is_new.shape)
    dcg = (t_sorted * avg_disc).sum(-1)

    # ideal DCG: sorted by true relevance, no tie handling (sklearn)
    ideal = torch.sort(target * mask, dim=-1).values.flip(-1)
    idcg = (ideal * torch.where(pos < k, 1.0 / torch.log2(pos + 2.0), 0.0)).sum(-1)
    return torch.where(idcg > 0, dcg / _flushed_floor(idcg), 0.0)
