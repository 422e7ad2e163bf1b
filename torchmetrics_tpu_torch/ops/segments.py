"""Segment reductions over unsorted segment ids (counterpart of ``torchmetrics_tpu/ops/segments.py``).

Each function takes ``data`` of shape ``(N, ...)``, ``segment_ids`` of shape ``(N,)`` and a static
``num_segments``, and returns ``(num_segments, ...)``, as ``jax.ops.segment_*`` do:

- an id outside ``[0, num_segments)`` is dropped;
- an empty segment holds 0 for sum and count, the dtype's lowest value for max (``-inf`` for a
  float) and its highest for min (``+inf``): ``jax.ops.segment_max/min``'s identities, not the
  ``include_self`` defaults of ``scatter_reduce``;
- max and min propagate NaN.

They are built on ``index_add_`` and ``scatter_reduce_``, with no read of the device, so they may
run inside a captured CUDA graph. The sorted, contiguous segments of the retrieval engine take
:func:`segment_offsets` and :func:`sorted_segment_reduce` instead.

Determinism: integer sums and counts, max and min are exact in any order. A float ``index_add_``
on CUDA adds with atomics, so the last bits of a float sum depend on the order in which the
threads land, and two runs may differ there; on the CPU it adds in input order.
:func:`sorted_segment_reduce` reduces each segment in a fixed order (``torch.segment_reduce``) and is
bitwise repeatable on both devices.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor


def _routed(segment_ids: Tensor, num_segments: int) -> Tensor:
    """The ids as int64, with every id outside ``[0, num_segments)`` sent to the spare segment
    ``num_segments``, which the callers cut off."""
    ids = segment_ids.reshape(-1).to(torch.int64)
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


def segment_sum(data: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, _routed(segment_ids, num_segments), data)[:num_segments]


def segment_count(segment_ids: Tensor, num_segments: int, dtype: torch.dtype = torch.int32) -> Tensor:
    """Number of elements per segment (empty segments count 0)."""
    return segment_sum(torch.ones(segment_ids.shape, dtype=dtype, device=segment_ids.device), segment_ids, num_segments)


def segment_mean_pair(data: Tensor, segment_ids: Tensor, num_segments: int) -> Tuple[Tensor, Tensor]:
    """Per-segment ``(sums, counts)``, the mergeable pair, not the ratio: two pairs merge by
    elementwise addition. Counts follow ``data``'s dtype."""
    return segment_sum(data, segment_ids, num_segments), segment_sum(torch.ones_like(data), segment_ids, num_segments)


def segment_mean(data: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    sums, counts = segment_mean_pair(data, segment_ids, num_segments)
    return sums / torch.clamp_min(counts, 1)


def _segment_extreme(data: Tensor, segment_ids: Tensor, num_segments: int, reduce: str) -> Tensor:
    if data.is_floating_point():
        identity = float("-inf") if reduce == "amax" else float("inf")
    elif data.dtype == torch.bool:
        identity = reduce == "amin"
    else:
        info = torch.iinfo(data.dtype)
        identity = info.min if reduce == "amax" else info.max
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), identity, dtype=data.dtype, device=data.device)
    ids = _routed(segment_ids, num_segments).reshape((-1,) + (1,) * (data.dim() - 1)).expand(data.shape)
    return out.scatter_reduce_(0, ids, data, reduce, include_self=True)[:num_segments]


def segment_max(data: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    return _segment_extreme(data, segment_ids, num_segments, "amax")


def segment_min(data: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    return _segment_extreme(data, segment_ids, num_segments, "amin")


def segment_offsets(sorted_ids: Tensor, num_segments: int) -> Tensor:
    """int64 ``(num_segments + 1,)`` bounds of the segments of a sorted, dense id stream: segment
    ``g`` spans ``offsets[g]:offsets[g + 1]`` (empty when equal). A binary search per bound, with no
    atomics."""
    ids = sorted_ids.reshape(-1).to(torch.int64)
    return torch.searchsorted(ids, torch.arange(num_segments + 1, device=ids.device))


def sorted_segment_reduce(data: Tensor, offsets: Tensor, reduce: str = "sum", initial: float = 0.0) -> Tensor:
    """Reduce the consecutive runs of ``data`` along dim 0 that ``offsets`` bounds (one run per
    segment, empty runs allowed) with ``reduce`` (``sum``, ``min`` or ``max``); an empty segment
    holds ``initial``. Each segment is reduced by one thread in input order, so the result is
    bitwise repeatable, and no value is read back to the host. The data goes in as 2-D, where
    ``torch.segment_reduce`` runs that one-thread-per-segment kernel on CUDA: on 1-D data it takes
    CUB's segmented reduction, one block per segment, which costs 0.6 ms over 2^20 mostly empty
    segments on an H100 (PERF.md §5)."""
    flat = data.reshape(data.shape[0], -1)
    out = torch.segment_reduce(flat, reduce, offsets=offsets, axis=0, unsafe=True, initial=initial)
    return out.reshape((offsets.shape[0] - 1,) + tuple(data.shape[1:]))
