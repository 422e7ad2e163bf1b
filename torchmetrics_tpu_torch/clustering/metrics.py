"""Module clustering metrics (counterpart of ``torchmetrics_tpu/clustering/metrics.py``).

The extrinsic metrics keep two ``cat`` list states, ``preds`` and ``target`` (``_LabelPairMetric``,
``metrics.py:35``); the intrinsic ones ``data`` and ``labels`` (``_DataLabelMetric``, ``:241``).
An update appends; the compute relabels the whole state on the device (a read of the device) and
runs the functional score, so both steps are eager on either dispatch tier, as in the JAX package
(``jit_update = jit_compute = False``: the gate notes ``jit_update_off``). The counting inside the
compute is K1's.
"""
from __future__ import annotations

from typing import Any, Dict, Literal, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.clustering import (
    adjusted_mutual_info_score,
    adjusted_rand_score,
    calinski_harabasz_score,
    completeness_score,
    davies_bouldin_score,
    dunn_index,
    fowlkes_mallows_index,
    homogeneity_score,
    mutual_info_score,
    normalized_mutual_info_score,
    rand_score,
    v_measure_score,
)
from torchmetrics_tpu_torch.functional.clustering.utils import _validate_average_method_arg
from torchmetrics_tpu_torch.metric import Metric


class _LabelPairMetric(Metric):
    """Shared shell of the extrinsic metrics: two label list states, a compute over all of them."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    jit_compute = False
    jit_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", default=[], dist_reduce_fx="cat")
        self.add_state("target", default=[], dist_reduce_fx="cat")

    def _update(self, state: Dict[str, Any], preds: Tensor, target: Tensor) -> Dict[str, Any]:
        return {"preds": torch.atleast_1d(preds), "target": torch.atleast_1d(target)}

    def _functional(self, preds: Tensor, target: Tensor) -> Tensor:
        raise NotImplementedError

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        return self._functional(state["preds"], state["target"])


class MutualInfoScore(_LabelPairMetric):
    """Mutual information between clusterings (``metrics.py:61``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import MutualInfoScore
        >>> metric = MutualInfoScore(device="cpu")
        >>> metric.update(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 2]))
        >>> print(f"{float(metric.compute()):.4f}")
        0.6931
    """

    plot_upper_bound = None

    def _functional(self, preds, target):
        return mutual_info_score(preds, target)


class RandScore(_LabelPairMetric):
    """Rand score (``metrics.py:79``)."""

    def _functional(self, preds, target):
        return rand_score(preds, target)


class AdjustedRandScore(_LabelPairMetric):
    """Adjusted Rand score (``metrics.py:95``)."""

    plot_lower_bound = -0.5

    def _functional(self, preds, target):
        return adjusted_rand_score(preds, target)


class AdjustedMutualInfoScore(_LabelPairMetric):
    """Adjusted mutual information (``metrics.py:113``), with the port's float64 expected MI
    (``functional/clustering/extrinsic.py``)."""

    plot_lower_bound = -1.0

    def __init__(
        self, average_method: Literal["min", "geometric", "arithmetic", "max"] = "arithmetic", **kwargs: Any
    ) -> None:
        super().__init__(**kwargs)
        _validate_average_method_arg(average_method)
        self.average_method = average_method

    def _functional(self, preds, target):
        return adjusted_mutual_info_score(preds, target, self.average_method)


class NormalizedMutualInfoScore(_LabelPairMetric):
    """Normalized mutual information (``metrics.py:140``)."""

    def __init__(
        self, average_method: Literal["min", "geometric", "arithmetic", "max"] = "arithmetic", **kwargs: Any
    ) -> None:
        super().__init__(**kwargs)
        _validate_average_method_arg(average_method)
        self.average_method = average_method

    def _functional(self, preds, target):
        return normalized_mutual_info_score(preds, target, self.average_method)


class FowlkesMallowsIndex(_LabelPairMetric):
    """Fowlkes-Mallows index (``metrics.py:163``)."""

    def _functional(self, preds, target):
        return fowlkes_mallows_index(preds, target)


class HomogeneityScore(_LabelPairMetric):
    """Homogeneity (``metrics.py:181``)."""

    def _functional(self, preds, target):
        return homogeneity_score(preds, target)


class CompletenessScore(_LabelPairMetric):
    """Completeness (``metrics.py:199``)."""

    def _functional(self, preds, target):
        return completeness_score(preds, target)


class VMeasureScore(_LabelPairMetric):
    """V-measure (``metrics.py:217``)."""

    def __init__(self, beta: Union[int, float] = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(beta, (int, float)) and beta > 0):
            raise ValueError(f"Argument `beta` must be a positive float. Got {beta}.")
        self.beta = beta

    def _functional(self, preds, target):
        return v_measure_score(preds, target, self.beta)


class _DataLabelMetric(Metric):
    """Shared shell of the intrinsic metrics: ``data`` and ``labels`` list states."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    jit_compute = False
    jit_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("data", default=[], dist_reduce_fx="cat")
        self.add_state("labels", default=[], dist_reduce_fx="cat")

    def _update(self, state: Dict[str, Any], data: Tensor, labels: Tensor) -> Dict[str, Any]:
        return {"data": torch.atleast_2d(data), "labels": torch.atleast_1d(labels)}


class CalinskiHarabaszScore(_DataLabelMetric):
    """Calinski-Harabasz score (``metrics.py:260``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.clustering import CalinskiHarabaszScore
        >>> metric = CalinskiHarabaszScore(device="cpu")
        >>> metric.update(torch.tensor([[0.0, 0.0], [0.5, 0.0], [8.0, 8.0], [8.5, 8.0]]), torch.tensor([0, 0, 1, 1]))
        >>> print(f"{float(metric.compute()):.4f}")
        1024.0000
    """

    def _compute(self, state):
        return calinski_harabasz_score(state["data"], state["labels"])


class DaviesBouldinScore(_DataLabelMetric):
    """Davies-Bouldin score (``metrics.py:278``)."""

    higher_is_better = False

    def _compute(self, state):
        return davies_bouldin_score(state["data"], state["labels"])


class DunnIndex(_DataLabelMetric):
    """Dunn index (``metrics.py:298``)."""

    def __init__(self, p: Union[int, float] = 2, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.p = p

    def _compute(self, state):
        return dunn_index(state["data"], state["labels"], self.p)
