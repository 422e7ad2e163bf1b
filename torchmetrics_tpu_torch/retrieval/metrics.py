"""Concrete retrieval metrics (counterpart of ``torchmetrics_tpu/retrieval/metrics.py``, reference
``src/torchmetrics/retrieval/*.py``)."""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.retrieval._kernels import (
    average_precision_kernel,
    fall_out_kernel,
    hit_rate_kernel,
    ndcg_kernel,
    precision_kernel,
    r_precision_kernel,
    recall_kernel,
    reciprocal_rank_kernel,
)
from torchmetrics_tpu_torch.functional.retrieval import _flat
from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric, _masked_aggregate, _max_valid_per_query, _next_pow2


def _validate_top_k(top_k: Optional[int]) -> None:
    if top_k is not None and not (isinstance(top_k, int) and top_k > 0):
        raise ValueError("`top_k` has to be a positive integer or None")


class RetrievalMAP(RetrievalMetric):
    """Mean average precision (reference ``retrieval/average_precision.py``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalMAP
        >>> metric = RetrievalMAP(device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([0, 1, 1]),
        ...               indexes=torch.tensor([0, 0, 0]))
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, aggregation="mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        _validate_top_k(top_k)
        self.top_k = top_k

    def _metric_kernel(self, preds, target, mask):
        return average_precision_kernel(preds, target, mask, self.top_k)

    def _flat_values(self, ctx):
        return _flat.average_precision_flat(ctx)


class RetrievalMRR(RetrievalMetric):
    """Mean reciprocal rank (reference ``retrieval/reciprocal_rank.py``).

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([0, 1, 1])
        >>> indexes = torch.tensor([0, 0, 0])
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalMRR
        >>> metric = RetrievalMRR(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, aggregation="mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        _validate_top_k(top_k)
        self.top_k = top_k

    def _metric_kernel(self, preds, target, mask):
        return reciprocal_rank_kernel(preds, target, mask, self.top_k)

    def _flat_values(self, ctx):
        return _flat.reciprocal_rank_flat(ctx)


class RetrievalPrecision(RetrievalMetric):
    """precision@k (reference ``retrieval/precision.py``).

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([0, 1, 1])
        >>> indexes = torch.tensor([0, 0, 0])
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalPrecision
        >>> metric = RetrievalPrecision(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> print(f"{float(metric.compute()):.4f}")
        0.6667
    """

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, adaptive_k: bool = False, aggregation="mean",
                 **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        _validate_top_k(top_k)
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.top_k = top_k
        self.adaptive_k = adaptive_k

    def _metric_kernel(self, preds, target, mask):
        return precision_kernel(preds, target, mask, self.top_k, self.adaptive_k)

    def _flat_values(self, ctx):
        return _flat.make_precision_flat(self.top_k, self.adaptive_k)(ctx)


class RetrievalRecall(RetrievalMetric):
    """recall@k (reference ``retrieval/recall.py``).

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([0, 1, 1])
        >>> indexes = torch.tensor([0, 0, 0])
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalRecall
        >>> metric = RetrievalRecall(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, aggregation="mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        _validate_top_k(top_k)
        self.top_k = top_k

    def _metric_kernel(self, preds, target, mask):
        return recall_kernel(preds, target, mask, self.top_k)

    def _flat_values(self, ctx):
        return _flat.recall_flat(ctx)


class RetrievalFallOut(RetrievalMetric):
    """fall-out@k (reference ``retrieval/fall_out.py``); empty-*positive* queries handled on the
    negative-target axis: `empty_target_action` applies to queries with no NEGATIVE targets.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([0, 1, 1])
        >>> indexes = torch.tensor([0, 0, 0])
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalFallOut
        >>> metric = RetrievalFallOut(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    higher_is_better = False

    def __init__(self, empty_target_action: str = "pos", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, aggregation="mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        _validate_top_k(top_k)
        self.top_k = top_k

    def _metric_kernel(self, preds, target, mask):
        return fall_out_kernel(preds, target, mask, self.top_k)

    def _flat_values(self, ctx):
        return _flat.fall_out_flat(ctx)

    _empty_from = "neg"  # "empty" = no negative targets (reference fall_out.py:126)


class RetrievalHitRate(RetrievalMetric):
    """hit-rate@k (reference ``retrieval/hit_rate.py``).

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([0, 1, 1])
        >>> indexes = torch.tensor([0, 0, 0])
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalHitRate
        >>> metric = RetrievalHitRate(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, aggregation="mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        _validate_top_k(top_k)
        self.top_k = top_k

    def _metric_kernel(self, preds, target, mask):
        return hit_rate_kernel(preds, target, mask, self.top_k)

    def _flat_values(self, ctx):
        return _flat.hit_rate_flat(ctx)


class RetrievalRPrecision(RetrievalMetric):
    """R-precision (reference ``retrieval/r_precision.py``).

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([0, 1, 1])
        >>> indexes = torch.tensor([0, 0, 0])
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalRPrecision
        >>> metric = RetrievalRPrecision(device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    def _metric_kernel(self, preds, target, mask):
        return r_precision_kernel(preds, target, mask)

    def _flat_values(self, ctx):
        return _flat.r_precision_flat(ctx)


class RetrievalNormalizedDCG(RetrievalMetric):
    """NDCG@k with graded relevance (reference ``retrieval/ndcg.py``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalNormalizedDCG
        >>> metric = RetrievalNormalizedDCG(device="cpu")
        >>> metric.update(torch.tensor([0.2, 0.3, 0.5]), torch.tensor([0, 1, 1]),
        ...               indexes=torch.tensor([0, 0, 0]))
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    allow_non_binary_target = True

    def __init__(self, empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 top_k: Optional[int] = None, aggregation="mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        _validate_top_k(top_k)
        self.top_k = top_k

    def _metric_kernel(self, preds, target, mask):
        return ndcg_kernel(preds, target, mask, self.top_k)

    def _flat_values(self, ctx):
        return _flat.ndcg_flat(ctx)


class RetrievalPrecisionRecallCurve(RetrievalMetric):
    """Averaged precision/recall at k=1..max_k (reference ``retrieval/precision_recall_curve.py``).

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([0, 1, 1])
        >>> indexes = torch.tensor([0, 0, 0])
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalPrecisionRecallCurve
        >>> metric = RetrievalPrecisionRecallCurve(max_k=3, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> precision, recall, top_k = metric.compute()
        >>> top_k.tolist()
        [1, 2, 3]
    """

    def __init__(self, max_k: Optional[int] = None, adaptive_k: bool = False,
                 empty_target_action: str = "neg", ignore_index: Optional[int] = None,
                 aggregation="mean", **kwargs: Any) -> None:
        super().__init__(empty_target_action, ignore_index, aggregation, **kwargs)
        if max_k is not None and not (isinstance(max_k, int) and max_k > 0):
            raise ValueError('`max_k` must be a positive integer or None')
        if not isinstance(adaptive_k, bool):
            raise ValueError("`adaptive_k` has to be a boolean")
        self.max_k = max_k
        self.adaptive_k = adaptive_k

    def _compute(self, state) -> Tuple[Tensor, Tensor, Tensor]:
        arrays = self._state_arrays(state)
        if arrays is None:
            zero = torch.zeros((), device=self.device)
            return zero, zero, torch.zeros((), dtype=torch.int64, device=self.device)
        indexes, preds, target, valid = arrays
        # the one host read of the curve compute: max_k sizes the returned curves, and counts
        # only non-ignored docs
        max_k = self.max_k if self.max_k is not None else _max_valid_per_query(indexes, valid)
        precisions, recalls = self._curve_flat(indexes, preds, target, valid, max_k)
        return precisions, recalls, torch.arange(1, max_k + 1, device=self.device)

    def _curve_flat(self, indexes, preds, target, valid, max_k: int):
        """Every k = 1..max_k precision/recall aggregate in one program over the flat context.

        The program is sized to the next power of two above ``max_k`` (and the result sliced
        back), so that a longest query that grows by one between computes does not capture a new
        graph."""
        requested_k = max_k
        max_k = _next_pow2(max_k)
        action, adaptive, aggregation = self.empty_target_action, self.adaptive_k, self.aggregation
        device_agg = aggregation if isinstance(aggregation, str) else None

        def run(indexes, preds, target, valid):
            ctx = _flat.build_context(indexes, preds, target, valid, None)
            has_valid = ctx["n_valid_seg"] > 0
            empty = (ctx["pos_seg"] == 0) & has_valid
            include = has_valid & ~empty if action == "skip" else has_valid
            pv, rv = _flat.curve_counts(ctx, max_k, adaptive)  # (N, K) each
            if action != "skip":
                impute = 1.0 if action == "pos" else 0.0
                pv = torch.where(empty[:, None], impute, pv)
                rv = torch.where(empty[:, None], impute, rv)
            if device_agg is None:  # custom callable: the per-query columns go back to the host
                return pv, rv, include, empty.any()
            return _masked_aggregate(pv, include, device_agg), _masked_aggregate(rv, include, device_agg), empty.any()

        out = self._graph_compute(f"curve_flat@{max_k}", run, self._pad_flat(indexes, preds, target, valid))
        if device_agg is not None:
            p, r, any_empty = out
        else:
            pv, rv, include, any_empty = out
            keep = include.cpu().numpy()
            pv_np, rv_np = pv.cpu().numpy()[keep], rv.cpu().numpy()[keep]  # one copy each
            p = torch.stack([torch.as_tensor(aggregation(torch.as_tensor(pv_np[:, k], device=self.device)),
                                             device=self.device) for k in range(requested_k)])
            r = torch.stack([torch.as_tensor(aggregation(torch.as_tensor(rv_np[:, k], device=self.device)),
                                             device=self.device) for k in range(requested_k)])
        if action == "error" and bool(any_empty):
            # the one read of the "error" action, after the program
            raise ValueError("`compute` method was provided with a query with no positive target.")
        return p[:requested_k], r[:requested_k]


class RetrievalRecallAtFixedPrecision(RetrievalPrecisionRecallCurve):
    """(max recall, best k) such that precision >= min_precision (reference
    ``retrieval/recall_fixed_precision.py``).

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([0, 1, 1])
        >>> indexes = torch.tensor([0, 0, 0])
        >>> from torchmetrics_tpu_torch.retrieval import RetrievalRecallAtFixedPrecision
        >>> metric = RetrievalRecallAtFixedPrecision(min_precision=0.5, device="cpu")
        >>> metric.update(preds, target, indexes=indexes)
        >>> [round(float(v), 4) for v in metric.compute()]  # (recall, top_k)
        [1.0, 2.0]
    """

    def __init__(self, min_precision: float = 0.0, max_k: Optional[int] = None,
                 adaptive_k: bool = False, empty_target_action: str = "neg",
                 ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(max_k, adaptive_k, empty_target_action, ignore_index, **kwargs)
        if not (isinstance(min_precision, float) and 0.0 <= min_precision <= 1.0):
            raise ValueError('`min_precision` must be a positive float between 0 and 1')
        self.min_precision = min_precision

    def _compute(self, state):
        precisions, recalls, ks = super()._compute(state)
        p, r, k = precisions.cpu().numpy(), recalls.cpu().numpy(), ks.cpu().numpy()
        mask = p >= self.min_precision
        if not mask.any():
            return torch.zeros((), device=self.device), torch.tensor(int(k.max()), device=self.device)
        best = np.argmax(np.where(mask, r, -1.0))
        return torch.tensor(r[best], device=self.device), torch.tensor(int(k[best]), device=self.device)
