"""Stateful precision-recall curves (counterpart of ``torchmetrics_tpu/classification/precision_recall_curve.py``,
reference ``classification/precision_recall_curve.py:55,226,424,616``).

Three state regimes, as in the JAX package:

- ``thresholds=None`` (exact): ``cat`` list states of the formatted scores; compute finishes on
  the host with sklearn's semantics;
- ``thresholds=int|list|tensor`` (binned): one ``(T, ..., 2, 2)`` float32 confusion tensor with
  ``dist_reduce_fx="sum"``, updated by one launch of kernel K3 per batch;
- ``approx="sketch"``: a ``(..., sketch_bins)`` positive/negative histogram pair
  (:mod:`torchmetrics_tpu_torch.sketch.hist`), updated by one launch of kernel K2 per batch and
  equal to binned mode over the implicit ``linspace(0, 1, sketch_bins)`` grid; against exact mode
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
    _one_vs_rest,
)
from torchmetrics_tpu_torch.metric import Metric
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
        preds, target, weight, _ = _binary_precision_recall_curve_format(preds, target, None, self.ignore_index)
        if self.approx == "sketch":
            t = target.to(torch.float32)
            pos_hist, neg_hist = _sketch_hist.hist_update_pair(
                state["pos_hist"], state["neg_hist"], preds, weight * t, weight * (1.0 - t)
            )
            return {"pos_hist": pos_hist, "neg_hist": neg_hist}
        if self.thresholds is None:
            return {"preds": preds, "target": target, "weight": weight}
        return {"confmat": state["confmat"] + _binary_precision_recall_curve_update(preds, target, weight, self.thresholds)}

    def _compute(self, state) -> Tuple[Tensor, Tensor, Tensor]:
        return _binary_precision_recall_curve_compute(self._curve_state(state), self.thresholds)


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
        preds, target, weight, _ = _multiclass_precision_recall_curve_format(
            preds, target, self.num_classes, None, self.ignore_index, self.average
        )
        if self.approx == "sketch":
            if self.average == "micro":  # one-vs-rest flattened: a binary histogram pair
                t = target.to(torch.float32)
                pos_hist, neg_hist = _sketch_hist.hist_update_pair(
                    state["pos_hist"], state["neg_hist"], preds, weight * t, weight * (1.0 - t)
                )
            else:
                pos = _one_vs_rest(target, self.num_classes)
                w = weight[:, None]
                pos_hist, neg_hist = _sketch_hist.hist_update_classes(
                    state["pos_hist"], state["neg_hist"], preds, pos * w, (1.0 - pos) * w
                )
            return {"pos_hist": pos_hist, "neg_hist": neg_hist}
        if self.thresholds is None:
            return {"preds": preds, "target": target, "weight": weight}
        if self.average == "micro":
            update = _binary_precision_recall_curve_update(preds, target, weight, self.thresholds)
        else:
            update = _multiclass_precision_recall_curve_update(preds, target, weight, self.num_classes, self.thresholds)
        return {"confmat": state["confmat"] + update}

    def _compute(self, state):
        return _multiclass_precision_recall_curve_compute(
            self._curve_state(state), self.num_classes, self.thresholds, self.average
        )


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
        preds, target, weight, _ = _multilabel_precision_recall_curve_format(
            preds, target, self.num_labels, None, self.ignore_index
        )
        if self.approx == "sketch":
            t = target.to(torch.float32)
            pos_hist, neg_hist = _sketch_hist.hist_update_classes(
                state["pos_hist"], state["neg_hist"], preds, t * weight, (1.0 - t) * weight
            )
            return {"pos_hist": pos_hist, "neg_hist": neg_hist}
        if self.thresholds is None:
            return {"preds": preds, "target": target, "weight": weight}
        update = _multilabel_precision_recall_curve_update(preds, target, weight, self.num_labels, self.thresholds)
        return {"confmat": state["confmat"] + update}

    def _compute(self, state):
        return _multilabel_precision_recall_curve_compute(
            self._curve_state(state), self.num_labels, self.thresholds, self.ignore_index
        )


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
