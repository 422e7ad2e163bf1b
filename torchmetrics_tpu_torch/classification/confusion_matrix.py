"""Confusion-matrix metrics (counterpart of ``torchmetrics_tpu/classification/confusion_matrix.py``:
``BinaryConfusionMatrix:30``, ``MulticlassConfusionMatrix:66``, ``MultilabelConfusionMatrix:114``
and the task wrapper ``ConfusionMatrix:153``).

The state is one int64 ``confmat`` with ``dist_reduce_fx="sum"`` (int32 in the JAX package; a
JAX state carries over with :func:`torchmetrics_tpu_torch.interop.load_numpy_state`), updated by
one K1 launch per batch. ``plot`` is not ported: the port has no plotting utilities yet.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _confusion_matrix_reduce,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
    _multilabel_confusion_matrix_update,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import CountType, _check_task
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


class _ConfusionMatrix(Metric):
    """The state and compute the three classes share."""

    is_differentiable = False
    higher_is_better = None

    def _create_state(self, shape: tuple, ignore_index: Optional[int], normalize: Optional[str],
                      validate_args: bool) -> None:
        self.ignore_index = ignore_index
        self.normalize = normalize
        self.validate_args = validate_args
        self.add_state("confmat", torch.zeros(shape, dtype=CountType), dist_reduce_fx="sum")

    def _compute(self, state):
        return _confusion_matrix_reduce(state["confmat"], self.normalize)


class BinaryConfusionMatrix(_ConfusionMatrix):
    """Reference ``confusion_matrix.py:51``."""

    def __init__(self, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 normalize: Optional[str] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        self.threshold = threshold
        self._create_state((2, 2), ignore_index, normalize, validate_args)

    def _validate(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_confusion_matrix_tensor_validation(preds, target, self.ignore_index)

    def _update(self, state, preds, target):
        preds, target = _binary_confusion_matrix_format(preds, target, self.threshold)
        return {"confmat": state["confmat"] + _binary_confusion_matrix_update(preds, target, self.ignore_index)}

    def plot(self, val: Any = None, ax: Any = None, add_text: bool = True, labels: Any = None, cmap: Any = None) -> Any:
        """Plot the (or a provided) confusion matrix as a heatmap (JAX ``classification/confusion_matrix.py:59``)."""
        from torchmetrics_tpu_torch.utils.plot import plot_confusion_matrix

        val = val if val is not None else self.compute()
        return plot_confusion_matrix(val, ax=ax, add_text=add_text, labels=labels, cmap=cmap)


class MulticlassConfusionMatrix(_ConfusionMatrix):
    """Reference ``confusion_matrix.py:187``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.classification import MulticlassConfusionMatrix
        >>> metric = MulticlassConfusionMatrix(num_classes=3, device="cpu")
        >>> metric.update(torch.tensor([[0.16, 0.26, 0.58], [0.22, 0.61, 0.17],
        ...                             [0.71, 0.09, 0.20], [0.05, 0.82, 0.13]]), torch.tensor([2, 1, 0, 0]))
        >>> metric.compute().tolist()
        [[1, 1, 0], [0, 1, 0], [0, 0, 1]]
    """

    def __init__(self, num_classes: int, ignore_index: Optional[int] = None,
                 normalize: Optional[str] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        self.num_classes = num_classes
        self._create_state((num_classes, num_classes), ignore_index, normalize, validate_args)

    def _validate(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_confusion_matrix_tensor_validation(preds, target, self.num_classes, self.ignore_index)

    def _update(self, state, preds, target):
        preds, target = _multiclass_confusion_matrix_format(preds, target)
        update = _multiclass_confusion_matrix_update(preds, target, self.num_classes, self.ignore_index)
        return {"confmat": state["confmat"] + update}

    def plot(self, val: Any = None, ax: Any = None, add_text: bool = True, labels: Any = None, cmap: Any = None) -> Any:
        """Plot the (or a provided) confusion matrix as a heatmap (JAX ``classification/confusion_matrix.py:107``)."""
        from torchmetrics_tpu_torch.utils.plot import plot_confusion_matrix

        val = val if val is not None else self.compute()
        return plot_confusion_matrix(val, ax=ax, add_text=add_text, labels=labels, cmap=cmap)


class MultilabelConfusionMatrix(_ConfusionMatrix):
    """Reference ``confusion_matrix.py:327``."""

    def __init__(self, num_labels: int, threshold: float = 0.5, ignore_index: Optional[int] = None,
                 normalize: Optional[str] = None, validate_args: bool = True, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        self.num_labels = num_labels
        self.threshold = threshold
        self._create_state((num_labels, 2, 2), ignore_index, normalize, validate_args)

    def _validate(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_confusion_matrix_tensor_validation(preds, target, self.num_labels, self.ignore_index)

    def _update(self, state, preds, target):
        preds, target = _multilabel_confusion_matrix_format(preds, target, self.num_labels, self.threshold)
        update = _multilabel_confusion_matrix_update(preds, target, self.num_labels, self.ignore_index)
        return {"confmat": state["confmat"] + update}

    def plot(self, val: Any = None, ax: Any = None, add_text: bool = True, labels: Any = None, cmap: Any = None) -> Any:
        """Plot the (or a provided) confusion matrix as a heatmap (JAX ``classification/confusion_matrix.py:146``)."""
        from torchmetrics_tpu_torch.utils.plot import plot_confusion_matrix

        val = val if val is not None else self.compute()
        return plot_confusion_matrix(val, ax=ax, add_text=add_text, labels=labels, cmap=cmap)


class ConfusionMatrix(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``confusion_matrix.py:470``)."""

    def __new__(  # type: ignore[misc]
        cls, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
        num_labels: Optional[int] = None, normalize: Optional[str] = None,
        ignore_index: Optional[int] = None, validate_args: bool = True, **kwargs: Any,
    ):
        task = _check_task(task, num_classes, num_labels)
        kwargs.update({"normalize": normalize, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryConfusionMatrix(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            return MulticlassConfusionMatrix(num_classes, **kwargs)
        return MultilabelConfusionMatrix(num_labels, threshold, **kwargs)
