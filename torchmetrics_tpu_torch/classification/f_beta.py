"""Multiclass F-beta and F1 (counterpart of ``torchmetrics_tpu/classification/f_beta.py:38,105``)."""
from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.stat_scores import MulticlassStatScores
from torchmetrics_tpu_torch.functional.classification.f_beta import _fbeta_reduce, _validate_beta


class MulticlassFBetaScore(MulticlassStatScores):
    higher_is_better = True

    def __init__(self, beta: float, num_classes: int, top_k: int = 1, average: Optional[str] = "macro",
                 multidim_average: str = "global", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_classes=num_classes, top_k=top_k, average=average,
                         multidim_average=multidim_average, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _validate_beta(beta)
        self.validate_args = validate_args
        self.beta = beta

    def _compute(self, state):
        return _fbeta_reduce(state["tp"], state["fp"], state["tn"], state["fn"], self.beta,
                             average=self.average, multidim_average=self.multidim_average, top_k=self.top_k)


class MulticlassF1Score(MulticlassFBetaScore):
    """Reference ``f_beta.py:686``."""

    def __init__(self, num_classes: int, top_k: int = 1, average: Optional[str] = "macro",
                 multidim_average: str = "global", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(1.0, num_classes, top_k, average, multidim_average, ignore_index, validate_args, **kwargs)
