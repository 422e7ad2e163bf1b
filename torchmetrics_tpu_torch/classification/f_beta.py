"""F-beta and F1 (counterpart of ``torchmetrics_tpu/classification/f_beta.py``: the Binary,
Multiclass and Multilabel classes ``:17-134`` and the task wrappers ``FBetaScore:135`` and
``F1Score:174``)."""
from __future__ import annotations

from typing import Any, Optional

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.stat_scores import (
    BinaryStatScores,
    MulticlassStatScores,
    MultilabelStatScores,
    _stat_scores_task_metric,
)
from torchmetrics_tpu_torch.functional.classification.f_beta import _fbeta_reduce, _validate_beta


class BinaryFBetaScore(BinaryStatScores):
    higher_is_better = True

    def __init__(self, beta: float, threshold: float = 0.5, multidim_average: str = "global",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(threshold=threshold, multidim_average=multidim_average, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _validate_beta(beta)
        self.validate_args = validate_args
        self.beta = beta

    def _compute(self, state):
        return _fbeta_reduce(state["tp"], state["fp"], state["tn"], state["fn"], self.beta,
                             average="binary", multidim_average=self.multidim_average)


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


class MultilabelFBetaScore(MultilabelStatScores):
    higher_is_better = True

    def __init__(self, beta: float, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
                 multidim_average: str = "global", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(num_labels=num_labels, threshold=threshold, average=average,
                         multidim_average=multidim_average, ignore_index=ignore_index,
                         validate_args=False, **kwargs)
        if validate_args:
            _validate_beta(beta)
        self.validate_args = validate_args
        self.beta = beta

    def _compute(self, state):
        return _fbeta_reduce(state["tp"], state["fp"], state["tn"], state["fn"], self.beta,
                             average=self.average, multidim_average=self.multidim_average, multilabel=True)


class BinaryF1Score(BinaryFBetaScore):
    """Reference ``f_beta.py:551``."""

    def __init__(self, threshold: float = 0.5, multidim_average: str = "global",
                 ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(1.0, threshold, multidim_average, ignore_index, validate_args, **kwargs)


class MulticlassF1Score(MulticlassFBetaScore):
    """Reference ``f_beta.py:686``."""

    def __init__(self, num_classes: int, top_k: int = 1, average: Optional[str] = "macro",
                 multidim_average: str = "global", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(1.0, num_classes, top_k, average, multidim_average, ignore_index, validate_args, **kwargs)


class MultilabelF1Score(MultilabelFBetaScore):
    """Reference ``f_beta.py:858``."""

    def __init__(self, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
                 multidim_average: str = "global", ignore_index: Optional[int] = None,
                 validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(1.0, num_labels, threshold, average, multidim_average, ignore_index, validate_args, **kwargs)


class FBetaScore(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``f_beta.py:1026``)."""

    def __new__(  # type: ignore[misc]
        cls, task: str, beta: float = 1.0, threshold: float = 0.5, num_classes: Optional[int] = None,
        num_labels: Optional[int] = None, average: Optional[str] = "micro", multidim_average: str = "global",
        top_k: Optional[int] = 1, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ):
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        classes = (BinaryFBetaScore, MulticlassFBetaScore, MultilabelFBetaScore)
        return _stat_scores_task_metric(task, classes, threshold, num_classes, num_labels, average, top_k, kwargs,
                                        lead=(beta,))


class F1Score(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``f_beta.py:1090``)."""

    def __new__(  # type: ignore[misc]
        cls, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
        num_labels: Optional[int] = None, average: Optional[str] = "micro", multidim_average: str = "global",
        top_k: Optional[int] = 1, ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ):
        kwargs.update({"multidim_average": multidim_average, "ignore_index": ignore_index, "validate_args": validate_args})
        classes = (BinaryF1Score, MulticlassF1Score, MultilabelF1Score)
        return _stat_scores_task_metric(task, classes, threshold, num_classes, num_labels, average, top_k, kwargs)
