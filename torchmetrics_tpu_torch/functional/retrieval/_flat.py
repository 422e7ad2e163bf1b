"""The flat segment-reduce retrieval engine (counterpart of ``torchmetrics_tpu/functional/retrieval/_flat.py``).

Every metric is expressed over the flat stream of documents sorted by (query id ascending, score
descending), with per-query sums over the sorted, contiguous segments. All shapes are static in
the (padded) document count, so the whole compute (sort, group, kernel, empty action,
aggregation) reads nothing back to the host and runs on the card as one captured CUDA graph
(``retrieval/base.py``), as the JAX package runs it as one jitted program.

Layout, as in the JAX package: ignored documents (``ignore_index``) get the score ``_NEG`` and
count nowhere; queries are dense segment ids ``0..q-1`` with ``q`` unknown to the host, and the
segment axis is the document count, so segments ``>= q`` are empty and hold ``n_valid == 0``.

The sort. PyTorch has no sort over several keys, so :func:`sort_by_query_then` makes two stable
passes of ``torch.sort``: first by score, descending, over the reversed stream, then by query id.
Stability makes the second pass keep the first one's order inside each query, and the reversal
makes equal scores come out in reversed input order, the tertiary key of the JAX package's
``lax.sort``. Scores are sorted as integers (``_kernels.sortable``), which ties ``-0.0`` with
``+0.0`` and puts NaN after every number, as ``lax.sort``'s total order does; query ids of any
integer dtype, negative ones and the padding id ``iinfo(dtype).max`` included, sort as they are.
The JAX package also has a packed-key numpy sort for XLA:CPU (``host_sort_perm``); the port has
this one form on both devices.

Determinism. The per-query sums of non-integer values (AP's precision sum, NDCG's DCG, IDCG and
tie-group discounts) are ``torch.segment_reduce`` over the sorted segments
(``ops/segments.py::sorted_segment_reduce``), which adds each segment in a fixed order: the graph
tier, the eager tier and a rerun give the same bits. The within-query cumulative relevance keeps
the JAX package's global float32 cumsum difference, exact for binary targets below 2^24 documents.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.retrieval._kernels import _NEG, sortable
from torchmetrics_tpu_torch.ops.segments import segment_offsets, sorted_segment_reduce
from torchmetrics_tpu_torch.utils.compute import _flushed_floor


def sort_by_query_then(indexes: Tensor, key_desc: Tensor, *payload: Tensor) -> Tuple[Tensor, ...]:
    """``(indexes, key_desc, *payload)`` sorted by (query id ascending, key descending), ties in
    reversed input order: two stable sorts, by key over the reversed stream, then by query id."""
    n = indexes.shape[0]
    rev = torch.arange(n - 1, -1, -1, device=indexes.device)
    perm = rev[torch.sort(sortable(-key_desc)[rev], stable=True).indices]
    perm = perm[torch.sort(indexes[perm], stable=True).indices]
    return tuple(t[perm] for t in (indexes, key_desc) + payload)


def dense_groups(idx_sorted: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """``(is_new, gid, start)`` of a sorted id stream: segment starts, the dense 0-based segment id
    and the flat index of each element's segment start (a binary search for its own id)."""
    first = torch.ones(1, dtype=torch.bool, device=idx_sorted.device)
    is_new = torch.cat([first, idx_sorted[1:] != idx_sorted[:-1]])
    gid = torch.cumsum(is_new, 0) - 1
    return is_new, gid, torch.searchsorted(idx_sorted, idx_sorted)


def build_context(indexes: Tensor, preds: Tensor, target: Tensor, valid: Tensor, top_k: Optional[int]) -> Dict:
    """The per-document and per-segment quantities every flat kernel reads: per sorted document or
    per segment id, both of length N (segments ``>= q`` empty)."""
    n = indexes.shape[0]
    score = torch.where(valid > 0, preds, _NEG)
    idx_s, score_s, tgt_s, val_s = sort_by_query_then(indexes, score, target * valid, valid.to(torch.float32))
    is_new, gid, start = dense_groups(idx_s)
    rank = (torch.arange(n, device=indexes.device) - start).to(torch.float32) + 1.0  # 1-based within-query rank
    ctx = {"n": n, "idx_s": idx_s, "score_s": score_s, "tgt_s": tgt_s, "val_s": val_s, "gid": gid,
           "is_new": is_new, "start": start, "rank": rank, "offsets": segment_offsets(gid, n), "top_k": top_k}
    n_valid_seg = _seg(ctx, val_s)
    n_valid = n_valid_seg[gid]
    k_eff = n_valid if top_k is None else torch.clamp_max(n_valid, float(top_k))
    ctx.update(n_valid_seg=n_valid_seg, n_valid=n_valid, k_eff=k_eff,
               in_k=((rank <= k_eff) & (val_s > 0)).to(torch.float32),
               pos_seg=_seg(ctx, tgt_s))  # per-segment total relevance (graded sum for NDCG inputs)
    return ctx


def _seg(ctx: Dict, values: Tensor) -> Tensor:
    """Per-segment sums of a per-document quantity (dim 0), in a fixed order."""
    return sorted_segment_reduce(values, ctx["offsets"])


def average_precision_flat(ctx: Dict) -> Tensor:
    """AP per query: mean over relevant in-top-k docs of precision@rank (``_kernels.py``)."""
    # within-query cumulative relevance: the global cumsum re-based at each segment start
    c, start, tgt = torch.cumsum(ctx["tgt_s"], 0), ctx["start"], ctx["tgt_s"]
    within_cum = c - c[start] + tgt[start]
    prec = within_cum / ctx["rank"]
    w = tgt * ctx["in_k"]
    n_rel = _seg(ctx, w)
    return torch.where(n_rel > 0, _seg(ctx, prec * w) / torch.clamp_min(n_rel, 1.0), 0.0)


def reciprocal_rank_flat(ctx: Dict) -> Tensor:
    hit_rank = torch.where((ctx["tgt_s"] > 0) & (ctx["in_k"] > 0), ctx["rank"], float("inf"))
    first = sorted_segment_reduce(hit_rank, ctx["offsets"], "min", float("inf"))
    return torch.where(torch.isfinite(first), 1.0 / torch.clamp_min(first, 1.0), 0.0)


def make_precision_flat(top_k: Optional[int], adaptive_k: bool = False) -> Callable:
    """precision@k per query: hits bounded by ``min(k, n_valid)``; the denominator is the fixed
    ``k`` unless adaptive or None, where it is ``min(k, n_valid)`` (or ``n_valid`` for None)."""

    def precision_flat(ctx: Dict) -> Tensor:
        if top_k is None:
            k_doc, k_seg = ctx["n_valid"], ctx["n_valid_seg"]
        else:
            k_doc = torch.clamp_max(ctx["n_valid"], float(top_k))
            k_seg = torch.clamp_max(ctx["n_valid_seg"], float(top_k)) if adaptive_k else torch.full_like(
                ctx["n_valid_seg"], float(top_k))
        in_k = (ctx["rank"] <= k_doc) & (ctx["val_s"] > 0)
        hits = _seg(ctx, ctx["tgt_s"] * in_k)
        return torch.where(ctx["pos_seg"] > 0, hits / torch.clamp_min(k_seg, 1.0), 0.0)

    return precision_flat


def make_recall_flat(top_k: Optional[int]) -> Callable:
    """recall@k per query with an explicit k."""

    def recall_at_k(ctx: Dict) -> Tensor:
        if top_k is None:
            in_k = ctx["in_k"]
        else:
            k_doc = torch.clamp_max(ctx["n_valid"], float(top_k))
            in_k = ((ctx["rank"] <= k_doc) & (ctx["val_s"] > 0)).to(torch.float32)
        hits = _seg(ctx, ctx["tgt_s"] * in_k)
        total = ctx["pos_seg"]
        return torch.where(total > 0, hits / torch.clamp_min(total, 1.0), 0.0)

    return recall_at_k


recall_flat = make_recall_flat(None)


def curve_counts(ctx: Dict, max_k: int, adaptive_k: bool, k_tile: int = 128) -> Tuple[Tensor, Tensor]:
    """``(precision (N, K), recall (N, K))`` for every k in ``1..max_k`` by segment sums of a
    ``(docs, k)`` membership product, ``k_tile`` values of k at a time: the transient is at most
    ``N * k_tile`` floats (512 MB at 2^20 documents), the result ``N * max_k``. The hits are
    integer counts in float32, exact in any order."""
    k_vec = torch.arange(1, max_k + 1, dtype=torch.float32, device=ctx["rank"].device)

    def hits_for(kv: Tensor) -> Tensor:  # kv (T,) -> per-query hit counts (N, T)
        k_doc = torch.minimum(kv[None, :], ctx["n_valid"][:, None])
        in_k = (ctx["rank"][:, None] <= k_doc) & (ctx["val_s"][:, None] > 0)
        return _seg(ctx, ctx["tgt_s"][:, None] * in_k)

    hits = torch.cat([hits_for(k_vec[i:i + k_tile]) for i in range(0, max_k, k_tile)], 1)
    if adaptive_k:
        prec_den = torch.minimum(k_vec[None, :], ctx["n_valid_seg"][:, None])
    else:
        prec_den = k_vec[None, :].expand(hits.shape)
    has_pos = (ctx["pos_seg"] > 0)[:, None]
    precision = torch.where(has_pos, hits / torch.clamp_min(prec_den, 1.0), 0.0)
    recall = torch.where(has_pos, hits / torch.clamp_min(ctx["pos_seg"][:, None], 1.0), 0.0)
    return precision, recall


def fall_out_flat(ctx: Dict) -> Tensor:
    irrel = ctx["val_s"] - ctx["tgt_s"]
    hits = _seg(ctx, irrel * ctx["in_k"])
    total = ctx["n_valid_seg"] - ctx["pos_seg"]
    return torch.where(total > 0, hits / torch.clamp_min(total, 1.0), 0.0)


def hit_rate_flat(ctx: Dict) -> Tensor:
    return (_seg(ctx, ctx["tgt_s"] * ctx["in_k"]) > 0).to(torch.float32)


def r_precision_flat(ctx: Dict) -> Tensor:
    r = ctx["pos_seg"]
    in_r = (ctx["rank"] <= r[ctx["gid"]]) & (ctx["val_s"] > 0)
    hits = _seg(ctx, ctx["tgt_s"] * in_r)
    return torch.where(r > 0, hits / torch.clamp_min(r, 1.0), 0.0)


def ndcg_flat(ctx: Dict) -> Tensor:
    """NDCG with tie-averaged DCG (sklearn semantics; rectangle twin ``_kernels.ndcg_kernel``)."""
    n = ctx["n"]
    discount = torch.where(ctx["in_k"] > 0, 1.0 / torch.log2(ctx["rank"] + 1.0), 0.0)
    # tie groups: runs of equal score within a query
    score = ctx["score_s"]
    first = torch.ones(1, dtype=torch.bool, device=score.device)
    tie_new = ctx["is_new"] | torch.cat([first, score[1:] != score[:-1]])
    tie_gid = torch.cumsum(tie_new, 0) - 1
    tie_bounds = segment_offsets(tie_gid, n)
    tie_disc = sorted_segment_reduce(discount, tie_bounds)
    tie_cnt = (tie_bounds[1:] - tie_bounds[:-1]).to(torch.float32)
    avg_disc = (tie_disc / torch.clamp_min(tie_cnt, 1.0))[tie_gid]
    dcg = _seg(ctx, ctx["tgt_s"] * avg_disc)

    # ideal DCG: docs re-sorted by true relevance within the query, plain discounts; the
    # segment layout and the within-query positions are the first sort's
    rel_key = torch.where(ctx["val_s"] > 0, ctx["tgt_s"], _NEG)
    _, _, ideal_tgt, ideal_val = sort_by_query_then(ctx["idx_s"], rel_key, ctx["tgt_s"], ctx["val_s"])
    ideal_disc = torch.where((ctx["rank"] <= ctx["k_eff"]) & (ideal_val > 0), 1.0 / torch.log2(ctx["rank"] + 1.0), 0.0)
    idcg = _seg(ctx, ideal_tgt * ideal_disc)
    return torch.where(idcg > 0, dcg / _flushed_floor(idcg), 0.0)
