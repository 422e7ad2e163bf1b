"""RetrievalMetric base (counterpart of ``torchmetrics_tpu/retrieval/base.py``, reference
``src/torchmetrics/retrieval/base.py:43``).

State: three ``cat`` list states (``indexes``, ``preds``, ``target``) with ``dist_reduce_fx=None``.
Scores are kept as float32 when they come as float64, as the JAX package keeps them with 64-bit
mode off; other float dtypes are kept. Query ids keep their integer dtype: the JAX package wraps
int64 ids to int32, the port does not.

Two compute paths, as in the JAX package:

- the flat path (``functional/retrieval/_flat.py``), taken by every metric with a per-document
  formulation and a named aggregation: sort, group, kernel, empty action and aggregation read
  nothing back to the host, so on the card they run as one captured CUDA graph per padded length
  and aggregation (``Metric._graph_compute``), keyed like the JAX package's ``_jit_cache``. The
  ``"error"`` action reads its flag after the replay;
- the rectangle path (``_grouped_values``, ``_grouped_aggregate``): two shape-setting reads of the
  host (number of queries, longest query), then the documents scattered into a padded
  ``(Q, L_max)`` batch and the masked kernels of ``_kernels.py`` over its rows. It serves callable
  aggregations, whose per-query values go back to the host.

The streaming sketch mode (``approx="sketch"``, JAX ``base.py:156-177,198-296``) keeps no
document: each batch's queries are scored on the spot by the rectangle path and folded into O(1)
aggregates (value sum, count, min, max: sum, min and max reductions), and a count-min sketch of the
query ids (``sketch/countmin.py``, one K1 launch a batch) detects the one approximation this makes,
a query whose documents straddle an update batch and so are scored per fragment
(``straddled_queries``, never an underestimate; the compute warns when it is nonzero). With
query-aligned batches sketch mode equals exact mode. The update is eager (JAX: ``jit_update =
scan_update = False``): the rectangle's shape is read on the host each batch, and the ``"error"``
action reads its flag there.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.retrieval import _flat
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.ops.segments import segment_offsets, sorted_segment_reduce
from torchmetrics_tpu_torch.sketch.countmin import cm_query, cm_update
from torchmetrics_tpu_torch.sketch.state import countmin_spec, register_sketch_state
from torchmetrics_tpu_torch.utils.checks import _check_retrieval_inputs
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError, TorchMetricsUserWarning
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

_AGGREGATIONS = ("mean", "median", "min", "max")


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def _group_stats(indexes: Tensor) -> Tuple[int, int]:
    """(number of distinct queries, longest query length), read back to the host in one copy."""
    idx_s = torch.sort(indexes).values
    is_new, _gid, start = _flat.dense_groups(idx_s)
    within = torch.arange(idx_s.shape[0], device=idx_s.device) - start
    q, max_len = torch.stack([is_new.sum(), within.max() + 1]).tolist()
    return q, max_len


def _max_valid_per_query(indexes: Tensor, valid: Tensor) -> int:
    """The largest count of valid (not ignored) documents of any query, read back to the host."""
    order = torch.sort(indexes, stable=True).indices
    _is_new, gid, _start = _flat.dense_groups(indexes[order])
    counts = sorted_segment_reduce(valid[order], segment_offsets(gid, indexes.shape[0]))
    return int(counts.max())


def _build_rectangles(indexes: Tensor, preds: Tensor, target: Tensor, valid: Tensor, q_pad: int, l_max: int):
    """The flat ``(N,)`` streams scattered into padded ``(q_pad, l_max)`` query rectangles, with no
    read of the device: group ids from a stable sort of ``indexes``, positions within a group from
    the group starts."""
    order = torch.sort(indexes, stable=True).indices
    _is_new, gid, start = _flat.dense_groups(indexes[order])
    flat = gid * l_max + (torch.arange(indexes.shape[0], device=indexes.device) - start)

    def scat(v: Tensor) -> Tensor:
        out = torch.zeros(q_pad * l_max, dtype=torch.float32, device=v.device)
        return out.scatter_(0, flat, v.to(torch.float32)).reshape(q_pad, l_max)

    v_s = valid[order].to(torch.float32)
    return scat(preds[order]), scat(target[order].to(torch.float32) * v_s), scat(v_s)


def _masked_aggregate(values: Tensor, include: Tensor, aggregation: str) -> Tensor:
    """mean, median, min or max over dim 0 of ``values`` (``(N,)`` or ``(N, K)``) of the entries
    ``include`` selects, 0 when it selects none; no read of the device."""
    inc = include.to(torch.float32)
    m = inc.sum()
    sel = include.reshape((-1,) + (1,) * (values.dim() - 1))
    if aggregation == "mean":
        return torch.where(m > 0, (values * sel.to(values.dtype)).sum(0) / torch.clamp_min(m, 1.0), 0.0)
    if aggregation == "min":
        return torch.where(m > 0, torch.where(sel, values, float("inf")).amin(0), 0.0)
    if aggregation == "max":
        return torch.where(m > 0, torch.where(sel, values, float("-inf")).amax(0), 0.0)
    if aggregation == "median":
        v = torch.sort(torch.where(sel, values, float("inf")), dim=0).values
        lo = torch.clamp_min(torch.floor((m - 1) / 2), 0).to(torch.int64).reshape(1)
        hi = torch.clamp_min(torch.ceil((m - 1) / 2), 0).to(torch.int64).reshape(1)
        return torch.where(m > 0, (v.index_select(0, lo)[0] + v.index_select(0, hi)[0]) / 2.0, 0.0)
    raise ValueError(f"Unsupported fused aggregation: {aggregation!r}")


class RetrievalMetric(Metric):
    """Base for retrieval metrics (reference ``base.py:43``)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    #: grouping is data-dependent: the compute is never part of a forward's graph
    jit_compute = False
    allow_non_binary_target = False
    #: which per-query count makes a query empty, in both modes: "pos", or "neg" for FallOut
    _empty_from = "pos"

    def __init__(
        self,
        empty_target_action: str = "neg",
        ignore_index: Optional[int] = None,
        aggregation="mean",
        approx: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if empty_target_action not in ("error", "skip", "neg", "pos"):
            raise ValueError(f"Argument `empty_target_action` received a wrong value `{empty_target_action}`.")
        self.empty_target_action = empty_target_action
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError("Argument `ignore_index` must be an integer or None.")
        self.ignore_index = ignore_index
        # a callable may be a Metric, whose `==` builds a CompositionalMetric: test strings only
        if not ((isinstance(aggregation, str) and aggregation in _AGGREGATIONS) or callable(aggregation)):
            raise ValueError(
                "Argument `aggregation` must be one of `mean`, `median`, `min`, `max` or a custom callable."
            )
        self.aggregation = aggregation
        if approx not in (None, "sketch"):
            raise ValueError(f"Argument `approx` must be None or 'sketch', got {approx!r}")
        self.approx = approx
        if approx == "sketch":
            if type(self)._metric_kernel is RetrievalMetric._metric_kernel:
                raise TorchMetricsUserError(
                    f"{type(self).__name__} does not support approx='sketch' (no per-query"
                    " kernel to finalise batches with)."
                )
            if callable(aggregation) or aggregation == "median":
                raise TorchMetricsUserError(
                    "approx='sketch' keeps O(1) mergeable aggregates, which exist for"
                    " aggregation='mean'/'min'/'max' — median and custom callables need"
                    " the exact (cat-state) mode."
                )
            # the per-batch finalisation reads the rectangle's shape on the host: the update is eager
            self.jit_update = False
            self.scan_update = False
            self.add_state("value_sum", torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("query_count", torch.tensor(0.0), dist_reduce_fx="sum")
            self.add_state("value_min", torch.tensor(float("inf")), dist_reduce_fx="min")
            self.add_state("value_max", torch.tensor(float("-inf")), dist_reduce_fx="max")
            self.add_state("straddled", torch.tensor(0.0), dist_reduce_fx="sum")
            register_sketch_state(self, "query_cms", countmin_spec())
            return
        self.add_state("indexes", [], dist_reduce_fx=None)
        self.add_state("preds", [], dist_reduce_fx=None)
        self.add_state("target", [], dist_reduce_fx=None)

    def _validate(self, preds: Tensor, target: Tensor, indexes: Optional[Tensor] = None) -> None:
        if indexes is None or preds is None or target is None:
            raise ValueError("Arguments ``indexes``, ``preds`` and ``target`` cannot be None")
        _check_retrieval_inputs(indexes, preds, target, allow_non_binary_target=self.allow_non_binary_target,
                                ignore_index=self.ignore_index)

    def _update(self, state, preds: Tensor, target: Tensor, indexes: Optional[Tensor] = None):
        # reference argument order (base.py:134): update(preds, target, indexes); `_validate` checked them
        preds = preds.reshape(-1)
        if preds.dtype == torch.float64:
            preds = preds.to(torch.float32)
        if self.approx == "sketch":
            return self._sketch_update(state, indexes.reshape(-1), preds, target.reshape(-1).to(torch.float32))
        return {"indexes": indexes.reshape(-1), "preds": preds, "target": target.reshape(-1).to(torch.float32)}

    # ---------------------------------------------------------- streaming sketch mode
    def _sketch_update(self, state, indexes: Tensor, preds: Tensor, target: Tensor):
        """Score this batch's queries and fold them into the running aggregates (JAX ``base.py:198``):
        the rectangle path and the empty actions of exact mode, applied per batch."""
        if self.ignore_index is not None:
            valid = (target != self.ignore_index).to(torch.float32)
            target = target * valid
        else:
            valid = torch.ones(target.shape, dtype=torch.float32, device=target.device)
        values, pos_count, neg_count, valid_count = self._grouped_values(indexes, preds, target, valid=valid,
                                                                         capture=False)
        has_valid = valid_count > 0
        empty = ((pos_count if self._empty_from == "pos" else neg_count) == 0) & has_valid
        action = self.empty_target_action
        if action == "error":
            # the "error" action's one read of the host, at update time, as in the JAX package
            if bool(empty.any()):
                axis = "positive" if self._empty_from == "pos" else "negative"
                raise ValueError(f"`update` method was provided with a query with no {axis} target.")
            include = has_valid
        elif action == "skip":
            include = has_valid & ~empty
        else:
            values = torch.where(empty, 1.0 if action == "pos" else 0.0, values)
            include = has_valid
        return self._sketch_fold(state, indexes, values, include.to(torch.float32))

    @staticmethod
    def _sketch_fold(state, indexes: Tensor, values: Tensor, inc: Tensor):
        """Per-query values and the id stream into the sketch states (JAX ``base.py:242``): the four
        aggregates, then the ids sorted, the first of each run marked new, a new id that the sketch
        has seen before counted as straddled (``cm_query`` before ``cm_update``), and the new ids
        counted into the sketch. No read of the device."""
        ids_sorted = torch.sort(indexes, stable=True).values
        is_new = torch.ones(ids_sorted.shape, dtype=torch.bool, device=ids_sorted.device)
        is_new[1:] = ids_sorted[1:] != ids_sorted[:-1]
        seen = cm_query(state["query_cms"], ids_sorted) > 0
        return {
            "value_sum": state["value_sum"] + torch.sum(values * inc),
            "query_count": state["query_count"] + torch.sum(inc),
            "value_min": torch.minimum(state["value_min"], torch.amin(torch.where(inc > 0, values, float("inf")))),
            "value_max": torch.maximum(state["value_max"], torch.amax(torch.where(inc > 0, values, float("-inf")))),
            "straddled": state["straddled"] + torch.sum(is_new & seen).to(torch.float32),
            "query_cms": cm_update(state["query_cms"], ids_sorted, weights=is_new),
        }

    @property
    def straddled_queries(self) -> int:
        """Estimated queries whose documents spanned more than one update batch (sketch mode; never
        an underestimate). Each was scored per fragment; with query-aligned batches it is 0."""
        if self.approx != "sketch":
            return 0
        self._state.guard_readable()
        return int(self._state.tensors["straddled"])

    def _sketch_compute(self, state) -> Tensor:
        cnt = state["query_count"]
        straddled = int(state["straddled"])
        if straddled:
            rank_zero_warn(
                f"{type(self).__name__}(approx='sketch'): ~{straddled} query id(s) appeared"
                " in more than one update batch and were scored per fragment. Align query"
                " boundaries with update batches (or use exact mode) for exact values.",
                TorchMetricsUserWarning,
            )
        if self.aggregation == "min":
            return torch.where(cnt > 0, state["value_min"], 0.0)
        if self.aggregation == "max":
            return torch.where(cnt > 0, state["value_max"], 0.0)
        return torch.where(cnt > 0, state["value_sum"] / torch.clamp_min(cnt, 1.0), 0.0)

    # ------------------------------------------------------------ grouped kernel
    def _metric_kernel(self, preds: Tensor, target: Tensor, mask: Tensor) -> Tensor:
        """Masked kernel over the rows of a ``(Q, L)`` rectangle; subclasses return ``(Q,)``."""
        raise NotImplementedError

    def _grouped_values(self, indexes: Tensor, preds: Tensor, target: Tensor, valid: Optional[Tensor] = None,
                        capture: bool = True):
        """Group the queries and run the kernel over the rectangle's rows.

        After the two shape-setting host reads, one program (one graph per shape on the card, or
        eager with ``capture=False``: sketch mode's batches bring a new shape each) returns
        ``(values, pos_count, neg_count, valid_count)``, each ``(q,)``; ``valid_count == 0`` marks
        queries whose docs were all ``ignore_index``, which callers exclude.
        """
        kernel = self._metric_kernel
        if valid is None:
            valid = torch.ones(indexes.shape, dtype=torch.float32, device=indexes.device)
        q, max_len = _group_stats(indexes)
        q_pad, l_max = _next_pow2(q), _next_pow2(max_len)

        def run(indexes, preds, target, valid):
            preds_pad, target_pad, mask_pad = _build_rectangles(indexes, preds, target, valid, q_pad, l_max)
            values = kernel(preds_pad, target_pad, mask_pad)
            row_real = torch.arange(q_pad, device=indexes.device) < q
            # the q..q_pad padding rows count no valid document
            valid_count = torch.where(row_real, mask_pad.sum(1), 0.0)
            pos_count = (target_pad * mask_pad).sum(1)
            return values, pos_count, valid_count - pos_count, valid_count

        args = (indexes, preds, target, valid)
        values, pos, neg, cnt = self._graph_compute(("grouped_kernel", q_pad, l_max, q), run, args) if capture else run(*args)
        return values[:q], pos[:q], neg[:q], cnt[:q]

    def _grouped_aggregate(self, indexes: Tensor, preds: Tensor, target: Tensor, valid: Tensor, empty_from: str,
                           no_target_msg: str) -> Tensor:
        """Rectangle build, kernel, empty action and aggregation as one program after the two
        host reads. ``empty_from`` in {"pos", "neg"} picks which count defines an empty query
        (FallOut uses negatives, reference ``fall_out.py:126``)."""
        kernel = self._metric_kernel
        q, max_len = _group_stats(indexes)
        q_pad, l_max = _next_pow2(q), _next_pow2(max_len)
        action, aggregation = self.empty_target_action, self.aggregation

        def run(indexes, preds, target, valid):
            preds_pad, target_pad, mask_pad = _build_rectangles(indexes, preds, target, valid, q_pad, l_max)
            values = kernel(preds_pad, target_pad, mask_pad)
            valid_count = mask_pad.sum(1)
            pos_count = (target_pad * mask_pad).sum(1)
            has_valid = (torch.arange(q_pad, device=indexes.device) < q) & (valid_count > 0)
            empty = (pos_count == 0 if empty_from == "pos" else valid_count - pos_count == 0) & has_valid
            return self._impute_and_aggregate(values, empty, has_valid, action, aggregation), empty.any()

        result, any_empty = self._graph_compute(("grouped_agg", q_pad, l_max, q), run, (indexes, preds, target, valid))
        if action == "error" and bool(any_empty):
            # the one read of the "error" action, after the program, as the JAX package reads it
            raise ValueError(no_target_msg)
        return result

    @staticmethod
    def _impute_and_aggregate(values: Tensor, empty: Tensor, has_valid: Tensor, action: str, aggregation: str) -> Tensor:
        if action == "skip":
            include = has_valid & ~empty
        else:
            values = torch.where(empty, 1.0 if action == "pos" else 0.0, values)
            include = has_valid
        return _masked_aggregate(values, include, aggregation)

    # ------------------------------------------------------------ flat (segment-reduce) path
    def _flat_values(self, ctx):
        """Per-query values over the flat sorted-doc context, or ``None`` for the rectangle path.
        Subclasses override."""
        return None

    @staticmethod
    def _pad_flat(indexes: Tensor, preds: Tensor, target: Tensor, valid: Tensor):
        """Pad the flat doc streams to a power of two, so that the graphs stay few. Filler docs carry
        the largest query id (they sort last, forming empty segments) and ``valid=0``."""
        n = int(indexes.shape[0])
        pad = _next_pow2(n) - n
        if not pad:
            return indexes, preds, target, valid

        def grow(x: Tensor, fill) -> Tensor:
            return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype, device=x.device)])

        return grow(indexes, torch.iinfo(indexes.dtype).max), grow(preds, 0), grow(target, 0), grow(valid, 0)

    def _flat_aggregate(self, indexes: Tensor, preds: Tensor, target: Tensor, valid: Tensor, empty_from: str,
                        no_target_msg: str) -> Tensor:
        """Sort, segment kernel, empty action and aggregation as one program (one graph per padded
        length on the card), with no shape-setting read of the host."""
        action, aggregation, top_k = self.empty_target_action, self.aggregation, getattr(self, "top_k", None)

        def run(indexes, preds, target, valid):
            ctx = _flat.build_context(indexes, preds, target, valid, top_k)
            n_valid_seg, pos_seg = ctx["n_valid_seg"], ctx["pos_seg"]
            has_valid = n_valid_seg > 0
            empty = (pos_seg == 0 if empty_from == "pos" else n_valid_seg - pos_seg == 0) & has_valid
            return self._impute_and_aggregate(self._flat_values(ctx), empty, has_valid, action, aggregation), empty.any()

        result, any_empty = self._graph_compute("flat_agg", run, self._pad_flat(indexes, preds, target, valid))
        if action == "error" and bool(any_empty):
            # the one read of the "error" action, after the replay, as the JAX package reads it
            raise ValueError(no_target_msg)
        return result

    def _state_arrays(self, state):
        """``(indexes, preds, target, valid)`` of the concatenated state, or None when it is empty."""
        indexes = state["indexes"]
        if isinstance(indexes, list) or indexes.numel() == 0:
            return None
        target = state["target"].to(torch.float32)
        if self.ignore_index is not None:
            valid = (target != self.ignore_index).to(torch.float32)
            target = target * valid
        else:
            valid = torch.ones(target.shape, dtype=torch.float32, device=target.device)
        return indexes, state["preds"], target, valid

    def _select_values(self, values: Tensor, empty: Tensor, has_valid: Tensor, no_target_msg: str) -> np.ndarray:
        """Apply the empty action and drop fully ignored queries, on the host, over ``(q,)`` values."""
        values_np = values.cpu().numpy()
        has_valid = has_valid.cpu().numpy()
        empty = empty.cpu().numpy() & has_valid
        if self.empty_target_action == "error" and bool(empty.any()):
            raise ValueError(no_target_msg)
        if self.empty_target_action == "skip":
            return values_np[~empty & has_valid]
        values_np = np.where(empty, 1.0 if self.empty_target_action == "pos" else 0.0, values_np)
        return values_np[has_valid]

    def _compute(self, state):
        """The compute of the scalar metrics; ``_empty_from`` as ``empty_from`` in ``_grouped_aggregate``."""
        empty_from = self._empty_from
        if self.approx == "sketch":
            return self._sketch_compute(state)
        arrays = self._state_arrays(state)
        if arrays is None:
            return torch.zeros((), device=self.device)
        indexes, preds, target, valid = arrays
        msg = f"`compute` method was provided with a query with no {'positive' if empty_from == 'pos' else 'negative'} target."
        if callable(self.aggregation):  # custom aggregations run on the host (rectangle path)
            values, pos_count, neg_count, valid_count = self._grouped_values(indexes, preds, target, valid=valid)
            empty = pos_count == 0 if empty_from == "pos" else neg_count == 0
            values_np = self._select_values(values, empty, valid_count > 0, msg)
            return self.aggregation(torch.as_tensor(values_np, device=self.device))
        if type(self)._flat_values is not RetrievalMetric._flat_values:
            return self._flat_aggregate(indexes, preds, target, valid, empty_from, msg)
        return self._grouped_aggregate(indexes, preds, target, valid, empty_from, msg)
