"""Stateful precision-recall curves (counterpart of ``torchmetrics_tpu/classification/precision_recall_curve.py``,
reference ``classification/precision_recall_curve.py:55,226,424,616``).

Three state regimes, as in the JAX package:

- ``thresholds=None`` (exact): ``cat`` list states of the formatted scores; compute finishes on
  the host with sklearn's semantics;
- ``thresholds=int|list|tensor`` (binned): one ``(T, ..., 2, 2)`` float32 confusion tensor with
  ``dist_reduce_fx="sum"``, updated by one launch of kernel K3's binned entry per batch;
- ``approx="sketch"``: a ``(..., sketch_bins)`` positive/negative histogram pair
  (:mod:`torchmetrics_tpu_torch.sketch.hist`), updated by one launch of kernel K2's fused entry
  ``sketch_update`` per batch, which reads the scores and the raw target and writes the new state,
  and equal to binned mode over the implicit ``linspace(0, 1, sketch_bins)`` grid; against exact mode
  the error is the grid's discretisation (``sketch.auroc_error_bound``).

``plot`` is not ported: the port has no plotting utilities yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    Thresholds,
    _adjust_threshold_arg,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _counts_to_confmat,
    _exact_state,
    _micro_exact_state,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.ops.hist_pair import sketch_update
from torchmetrics_tpu_torch.sketch import hist as _sketch_hist
from torchmetrics_tpu_torch.sketch.state import hist_spec, register_sketch_state
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


def _validate_approx(approx: Optional[str], thresholds: Any) -> None:
    """The ``approx`` argument's contract for the whole curve family."""
    if approx not in (None, "sketch"):
        raise ValueError(f"Argument `approx` must be None or 'sketch', got {approx!r}")
    if approx == "sketch" and thresholds is not None:
        raise ValueError(
            "approx='sketch' replaces the threshold grid with its own `sketch_bins`-wide"
            " implicit uniform grid — pass thresholds=None (exact-mode signature), or use"
            " plain binned mode (thresholds=int) without approx."
        )


def _sketch_state(state: Dict[str, Tensor], preds: Tensor, target: Tensor, kind: str,
                  ignore_index: Optional[int]) -> Dict[str, Tensor]:
    """The sketch's new histogram pair after a formatted batch: one launch of K2's ``sketch_update``,
    which reads the raw target and drops ``ignore_index`` itself; a target of a type the kernel does
    not read is widened to int64 first."""
    if target.dtype not in (torch.int32, torch.int64):
        target = target.to(torch.int64)
    pos_hist, neg_hist = sketch_update(preds.to(torch.float32).contiguous(), target.contiguous(), state["pos_hist"],
                                       state["neg_hist"], kind, ignore_index)
    return {"pos_hist": pos_hist, "neg_hist": neg_hist}


class _CurveMetric(Metric):
    """The state regimes that the three curve classes share."""

    is_differentiable = False
    higher_is_better = None

    def _create_curve_state(
        self, thresholds: Thresholds, approx: Optional[str], sketch_bins: int, rows: Tuple[int, ...],
        sketch_classes: Optional[int],
    ) -> None:
        """Register the states of the chosen regime; ``rows`` are the binned state's class axes."""
        self.approx = approx
        self.sketch_bins = int(sketch_bins)
        if approx == "sketch":
            # sketch mode is binned mode over the implicit uniform grid: every compute of the family
            # sees a threshold tensor and a confmat, but the resident state is the histogram pair
            self.thresholds = _adjust_threshold_arg(self.sketch_bins, self.device)
            register_sketch_state(self, "pos_hist", hist_spec(bins=self.sketch_bins, classes=sketch_classes))
            register_sketch_state(self, "neg_hist", hist_spec(bins=self.sketch_bins, classes=sketch_classes))
            return
        self.thresholds = _adjust_threshold_arg(thresholds, self.device)
        if self.thresholds is None:
            self.add_state("preds", [], dist_reduce_fx="cat")
            self.add_state("target", [], dist_reduce_fx="cat")
            self.add_state("weight", [], dist_reduce_fx="cat")
        else:
            shape = (self.thresholds.shape[0], *rows, 2, 2)
            self.add_state("confmat", torch.zeros(shape, dtype=torch.float32), dist_reduce_fx="sum")

    def _curve_state(self, state: Dict[str, Any]) -> Union[Tensor, Tuple[Tensor, Tensor, Tensor]]:
        """The state as the functional computes take it: a ``(T, ..., 2, 2)`` confmat or the
        exact ``(preds, target, weight)``."""
        if self.approx == "sketch":
            tp, fp, tn, fn = _sketch_hist.hist_threshold_counts(state["pos_hist"], state["neg_hist"])
            if tp.ndim == 1:
                return _counts_to_confmat(tp, fp, tn, fn)  # (T, 2, 2)
            return _counts_to_confmat(tp.T, fp.T, tn.T, fn.T)  # (T, C, 2, 2)
        if self.thresholds is None:
            return state["preds"], state["target"], state["weight"]
        return state["confmat"]

    def to(self, device: Union[str, torch.device]) -> "_CurveMetric":
        super().to(device)
        if self.thresholds is not None:
            self.thresholds = self.thresholds.to(self.device)
        return self


class BinaryPrecisionRecallCurve(_CurveMetric):
    """Reference ``classification/precision_recall_curve.py:55``."""

    def __init__(
        self,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        approx: Optional[str] = None,
        sketch_bins: int = _sketch_hist.DEFAULT_BINS,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _validate_approx(approx, thresholds)
        if validate_args:
            _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_curve_state(thresholds, approx, sketch_bins, rows=(), sketch_classes=None)

    def _validate(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _binary_precision_recall_curve_tensor_validation(preds, target, self.ignore_index)

    def _update(self, state, preds, target):
        preds, target, _ = _binary_precision_recall_curve_format(preds, target)
        if self.approx == "sketch":
            return _sketch_state(state, preds, target, "binary", self.ignore_index)
        if self.thresholds is not None:
            update = _binary_precision_recall_curve_update(preds, target, self.thresholds, self.ignore_index)
            return {"confmat": state["confmat"] + update}
        preds, target, weight = _exact_state(preds, target, self.ignore_index)
        return {"preds": preds, "target": target, "weight": weight}

    def _compute(self, state) -> Tuple[Tensor, Tensor, Tensor]:
        return _binary_precision_recall_curve_compute(self._curve_state(state), self.thresholds)

    def plot(self, curve: Any = None, score: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) curve (JAX ``classification/precision_recall_curve.py:145``)."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve or self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=('Recall', 'Precision'))


class MulticlassPrecisionRecallCurve(_CurveMetric):
    """Reference ``classification/precision_recall_curve.py:226``."""

    def __init__(
        self,
        num_classes: int,
        thresholds: Thresholds = None,
        average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        approx: Optional[str] = None,
        sketch_bins: int = _sketch_hist.DEFAULT_BINS,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _validate_approx(approx, thresholds)
        if validate_args:
            _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        self.num_classes = num_classes
        self.average = average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        micro = average == "micro"
        self._create_curve_state(thresholds, approx, sketch_bins, rows=() if micro else (num_classes,),
                                 sketch_classes=None if micro else num_classes)

    def _validate(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multiclass_precision_recall_curve_tensor_validation(preds, target, self.num_classes, self.ignore_index)

    def _update(self, state, preds, target):
        preds, target, _ = _multiclass_precision_recall_curve_format(preds, target, self.num_classes)
        if self.approx == "sketch":  # micro: the one-vs-rest pairs of every class into one histogram pair
            kind = "multiclass_micro" if self.average == "micro" else "multiclass"
            return _sketch_state(state, preds, target, kind, self.ignore_index)
        if self.thresholds is not None:
            update = _multiclass_precision_recall_curve_update(
                preds, target, self.num_classes, self.thresholds, self.ignore_index, self.average
            )
            return {"confmat": state["confmat"] + update}
        if self.average == "micro":
            preds, target, weight = _micro_exact_state(preds, target, self.num_classes, self.ignore_index)
        else:
            preds, target, weight = _exact_state(preds, target, self.ignore_index)
        return {"preds": preds, "target": target, "weight": weight}

    def _compute(self, state):
        return _multiclass_precision_recall_curve_compute(
            self._curve_state(state), self.num_classes, self.thresholds, self.average
        )

    def plot(self, curve: Any = None, score: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) curve (JAX ``classification/precision_recall_curve.py:250``)."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve or self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=('Recall', 'Precision'))


class MultilabelPrecisionRecallCurve(_CurveMetric):
    """Reference ``classification/precision_recall_curve.py:424``."""

    def __init__(
        self,
        num_labels: int,
        thresholds: Thresholds = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        approx: Optional[str] = None,
        sketch_bins: int = _sketch_hist.DEFAULT_BINS,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _validate_approx(approx, thresholds)
        if validate_args:
            _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_curve_state(thresholds, approx, sketch_bins, rows=(num_labels,), sketch_classes=num_labels)

    def _validate(self, preds: Tensor, target: Tensor) -> None:
        if self.validate_args:
            _multilabel_precision_recall_curve_tensor_validation(preds, target, self.num_labels, self.ignore_index)

    def _update(self, state, preds, target):
        preds, target, _ = _multilabel_precision_recall_curve_format(preds, target, self.num_labels)
        if self.approx == "sketch":
            return _sketch_state(state, preds, target, "multilabel", self.ignore_index)
        if self.thresholds is not None:
            update = _multilabel_precision_recall_curve_update(
                preds, target, self.num_labels, self.thresholds, self.ignore_index
            )
            return {"confmat": state["confmat"] + update}
        preds, target, weight = _exact_state(preds, target, self.ignore_index)
        return {"preds": preds, "target": target, "weight": weight}

    def _compute(self, state):
        return _multilabel_precision_recall_curve_compute(
            self._curve_state(state), self.num_labels, self.thresholds, self.ignore_index
        )

    def plot(self, curve: Any = None, score: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) curve (JAX ``classification/precision_recall_curve.py:339``)."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve or self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=('Recall', 'Precision'))


def _task_metric(
    task: str, num_classes: Optional[int], num_labels: Optional[int], classes, kwargs: Dict[str, Any],
    binary_args: Tuple = (), class_args: Tuple = (),
) -> Metric:
    """The binary, multiclass or multilabel class of ``classes`` for ``task``, the task wrappers'
    shared body: ``binary_args`` go first to the binary class, ``class_args`` after the class or
    label count to the others."""
    task = ClassificationTask.from_str(task)
    binary, multiclass, multilabel = classes
    if task == ClassificationTask.BINARY:
        return binary(*binary_args, **kwargs)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` must be `int` but `{type(num_classes)} was passed.`")
        return multiclass(num_classes, *class_args, **kwargs)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` must be `int` but `{type(num_labels)} was passed.`")
        return multilabel(num_labels, *class_args, **kwargs)
    raise ValueError(f"Task {task} not supported!")


class PrecisionRecallCurve(_ClassificationTaskWrapper):
    """Task dispatcher (reference ``precision_recall_curve.py:616``)."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Thresholds = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        classes = (BinaryPrecisionRecallCurve, MulticlassPrecisionRecallCurve, MultilabelPrecisionRecallCurve)
        return _task_metric(task, num_classes, num_labels, classes, kwargs)
