"""CosineSimilarity, KLDivergence, LogCoshError, MinkowskiDistance, TweedieDevianceScore
(counterpart of ``torchmetrics_tpu/regression/misc.py``).

``CosineSimilarity`` keeps its rows in ``cat`` list states, as ``KLDivergence`` keeps its
per-row values for ``reduction="none"``; the rest are float32 sum states.
``TweedieDevianceScore._validate`` runs the domain check, which reads the device, before any graph.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.functional.regression.cosine_similarity import (
    _check_cosine_similarity_input,
    _cosine_similarity_compute,
)
from torchmetrics_tpu_torch.functional.regression.kl_divergence import _check_kld_input, _kld_update
from torchmetrics_tpu_torch.functional.regression.log_cosh import _log_cosh_error_compute, _log_cosh_error_update
from torchmetrics_tpu_torch.functional.regression.minkowski import (
    _check_minkowski_p,
    _minkowski_distance_compute,
    _minkowski_distance_update,
)
from torchmetrics_tpu_torch.functional.regression.tweedie_deviance import (
    _check_power,
    _domain_check,
    _tweedie_deviance_score_compute,
    _tweedie_deviance_score_update,
)
from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.regression.base import _check_num_outputs, _SameShape
from torchmetrics_tpu_torch.utils.checks import _check_same_shape


class CosineSimilarity(Metric):
    """Cosine similarity over the accumulated rows (``misc.py:31``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.regression import CosineSimilarity
        >>> metric = CosineSimilarity(device="cpu")  # reduction="sum"
        >>> metric.update(torch.tensor([[2.5, 0.0], [2.0, 8.0]]), torch.tensor([[3.0, -0.5], [2.0, 7.0]]))
        >>> print(f"{float(metric.compute()):.4f}")
        1.9858
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        allowed_reduction = ("sum", "mean", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def _validate(self, preds, target) -> None:
        _check_cosine_similarity_input(preds, target)

    def _update(self, state, preds, target):
        return {"preds": preds.to(torch.float32), "target": target.to(torch.float32)}

    def _compute(self, state):
        return _cosine_similarity_compute(state["preds"], state["target"], self.reduction)


class KLDivergence(Metric):
    """KL(P||Q) (``misc.py:68``)."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, log_prob: bool = False, reduction: Optional[str] = "mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(log_prob, bool):
            raise TypeError(f"Argument `log_prob` must be bool but got {log_prob}")
        allowed_reduction = ("mean", "sum", "none", None)
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction} but got {reduction}")
        self.log_prob = log_prob
        self.reduction = reduction
        if reduction in ("none", None):
            self.add_state("measures", [], dist_reduce_fx="cat")
        else:
            self.add_state("measures", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _validate(self, p, q) -> None:
        _check_kld_input(p, q)

    def _update(self, state, p, q):
        measures, n = _kld_update(p, q, self.log_prob)
        if self.reduction in ("none", None):
            return {"measures": measures, "total": state["total"] + n}
        return {"measures": state["measures"] + torch.sum(measures), "total": state["total"] + n}

    def _compute(self, state):
        if self.reduction == "mean":
            return state["measures"] / state["total"]
        return state["measures"]


class LogCoshError(Metric):
    """LogCosh error (``misc.py:116``)."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, num_outputs: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_num_outputs(num_outputs, "an int larger than 0")
        self.num_outputs = num_outputs
        self.add_state("sum_log_cosh_error", torch.zeros((num_outputs,), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _validate(self, preds, target) -> None:
        _check_data_shape_to_num_outputs(preds, target, self.num_outputs)

    def _update(self, state, preds, target):
        s, n = _log_cosh_error_update(preds, target)
        return {"sum_log_cosh_error": state["sum_log_cosh_error"] + s, "total": state["total"] + n}

    def _compute(self, state):
        return _log_cosh_error_compute(state["sum_log_cosh_error"], state["total"])


class MinkowskiDistance(_SameShape):
    """Minkowski distance (``misc.py:151``)."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False

    def __init__(self, p: float, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_minkowski_p(p)
        self.p = p
        self.add_state("minkowski_dist_sum", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _update(self, state, preds, target):
        return {"minkowski_dist_sum": state["minkowski_dist_sum"] + _minkowski_distance_update(preds, target, self.p)}

    def _compute(self, state):
        return _minkowski_distance_compute(state["minkowski_dist_sum"], self.p)


class TweedieDevianceScore(Metric):
    """Tweedie deviance (``misc.py:185``). The domain check of ``power`` runs in ``_validate``, so
    the port raises on inputs out of the domain where the JAX package's jitted update accepts
    them (ROADMAP queue C)."""

    is_differentiable = True
    higher_is_better = None
    full_state_update = False

    def __init__(self, power: float = 0.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _check_power(power)
        self.power = power
        self.add_state("sum_deviance_score", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("num_observations", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _validate(self, preds, target) -> None:
        _check_same_shape(preds, target)
        _domain_check(preds, target, self.power)

    def _update(self, state, preds, target):
        s, n = _tweedie_deviance_score_update(preds, target, self.power)
        return {"sum_deviance_score": state["sum_deviance_score"] + s,
                "num_observations": state["num_observations"] + n}

    def _compute(self, state):
        return _tweedie_deviance_score_compute(state["sum_deviance_score"], state["num_observations"])
