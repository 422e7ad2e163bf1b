"""The IoU-family module metrics (counterpart of ``torchmetrics_tpu/detection/iou.py``).

Each image's overlap matrix has its own shape, so the matrices are list states on the metric's device
(``dist_reduce_fx=None``, as in JAX); each is one broadcast of corner algebra. ``class_metrics`` reads them
on the host once, as JAX's numpy loop does.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.detection.helpers import _fix_empty_boxes, _input_validator
from torchmetrics_tpu_torch.functional.detection.iou import (
    box_convert,
    box_iou,
    complete_box_iou,
    distance_box_iou,
    generalized_box_iou,
)
from torchmetrics_tpu_torch.metric import Metric


def _labels(x, device: torch.device) -> Tensor:
    """Labels as a flat int64 tensor on ``device``."""
    t = x if isinstance(x, Tensor) else torch.as_tensor(np.asarray(x))
    return t.reshape(-1).to(device=device, dtype=torch.int64)


class IntersectionOverUnion(Metric):
    """IoU over the detection and ground-truth boxes of each image (JAX ``detection/iou.py:22``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import IntersectionOverUnion
        >>> preds = [{"boxes": torch.tensor([[0.0, 0.0, 10.0, 10.0]]), "scores": torch.tensor([0.9]),
        ...           "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[0.0, 0.0, 10.0, 8.0]]), "labels": torch.tensor([0])}]
        >>> metric = IntersectionOverUnion(device="cpu")
        >>> metric.update(preds, target)
        >>> print(f"{float(metric.compute()['iou']):.4f}")
        0.8000
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    jit_update = False
    jit_compute = False

    _iou_type: str = "iou"
    _invalid_val: float = -1.0
    _pairwise_fn: Callable = staticmethod(box_iou)

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_threshold: Optional[float] = None,
        class_metrics: bool = False,
        respect_labels: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        self.iou_threshold = iou_threshold
        if not isinstance(class_metrics, bool):
            raise ValueError('Argument `class_metrics` must be a boolean')
        self.class_metrics = class_metrics
        if not isinstance(respect_labels, bool):
            raise ValueError('Argument `respect_labels` must be a boolean')
        self.respect_labels = respect_labels
        self.add_state("groundtruth_labels", [], dist_reduce_fx=None)
        self.add_state("iou_matrix", [], dist_reduce_fx=None)

    def update(self, preds: List[Dict[str, Any]], target: List[Dict[str, Any]]) -> None:  # noqa: D102
        self._guard_synced("update")
        _input_validator(preds, target, ignore_score=True)
        invalid = torch.full((), self._invalid_val, device=self.device)
        for p, t in zip(preds, target):
            det_boxes = self._get_safe_item_values(p["boxes"])
            gt_boxes = self._get_safe_item_values(t["boxes"])
            gt_labels = _labels(t["labels"], self.device)
            self._state.lists["groundtruth_labels"].append(gt_labels)
            iou_matrix = type(self)._pairwise_fn(det_boxes, gt_boxes)
            if self.iou_threshold is not None:
                iou_matrix = torch.where(iou_matrix < self.iou_threshold, invalid, iou_matrix)
            if self.respect_labels:
                label_eq = _labels(p["labels"], self.device)[:, None] == gt_labels[None, :]
                iou_matrix = torch.where(label_eq, iou_matrix, invalid)
            self._state.lists["iou_matrix"].append(iou_matrix)
        self._bump()

    def _get_safe_item_values(self, boxes) -> Tensor:
        boxes = _fix_empty_boxes(boxes, self.device)
        if boxes.numel() > 0:
            boxes = box_convert(boxes, in_fmt=self.box_format, out_fmt="xyxy")
        return boxes

    def _update(self, state, *args, **kwargs):  # pragma: no cover - update() is overridden
        raise NotImplementedError

    def _compute(self, state: Dict[str, Any]) -> Dict[str, Tensor]:
        mats = self._state.lists["iou_matrix"]
        gt_labels = self._state.lists["groundtruth_labels"]
        valid = [m[m != self._invalid_val] for m in mats]
        flat = torch.cat(valid) if valid else torch.zeros((0,), device=self.device)
        score = torch.mean(flat) if flat.numel() else torch.zeros((), device=self.device)
        results = {self._iou_type: score}
        if self.class_metrics:
            host_mats = [m.cpu().numpy() for m in mats]
            host_labels = [g.cpu().numpy().reshape(-1) for g in gt_labels]
            all_labels = np.unique(np.concatenate(host_labels)) if host_labels else np.zeros((0,), np.int64)
            for cl in all_labels.tolist():
                masked_sum, observed = 0.0, 0
                for mat, gl in zip(host_mats, host_labels):
                    scores = mat[:, gl == cl]
                    sel = scores[scores != self._invalid_val]
                    masked_sum += sel.sum()
                    observed += sel.size
                value = masked_sum / observed if observed else 0.0
                results[f"{self._iou_type}/cl_{cl}"] = torch.tensor(value, dtype=torch.float32, device=self.device)
        return results

    def compute(self) -> Dict[str, Tensor]:  # noqa: D102 - a dict of values, each squeezed
        with self.sync_context(dist_sync_fn=self.dist_sync_fn, should_sync=self._to_sync):
            return {k: self._squeeze_if_scalar(v) for k, v in self._compute({}).items()}


class GeneralizedIntersectionOverUnion(IntersectionOverUnion):
    """GIoU (JAX ``detection/iou.py:130``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import GeneralizedIntersectionOverUnion
        >>> preds = [{"boxes": torch.tensor([[0.0, 0.0, 10.0, 10.0]]), "scores": torch.tensor([0.9]),
        ...           "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[0.0, 0.0, 10.0, 8.0]]), "labels": torch.tensor([0])}]
        >>> metric = GeneralizedIntersectionOverUnion(device="cpu")
        >>> metric.update(preds, target)
        >>> print(f"{float(metric.compute()['giou']):.4f}")
        0.8000
    """

    _iou_type = "giou"
    _invalid_val = -1.0
    _pairwise_fn = staticmethod(generalized_box_iou)


class DistanceIntersectionOverUnion(IntersectionOverUnion):
    """DIoU (JAX ``detection/iou.py:151``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import DistanceIntersectionOverUnion
        >>> preds = [{"boxes": torch.tensor([[0.0, 0.0, 10.0, 10.0]]), "scores": torch.tensor([0.9]),
        ...           "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[0.0, 0.0, 10.0, 8.0]]), "labels": torch.tensor([0])}]
        >>> metric = DistanceIntersectionOverUnion(device="cpu")
        >>> metric.update(preds, target)
        >>> print(f"{float(metric.compute()['diou']):.4f}")
        0.7950
    """

    _iou_type = "diou"
    _invalid_val = -1.0
    _pairwise_fn = staticmethod(distance_box_iou)


class CompleteIntersectionOverUnion(IntersectionOverUnion):
    """CIoU (JAX ``detection/iou.py:172``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import CompleteIntersectionOverUnion
        >>> preds = [{"boxes": torch.tensor([[0.0, 0.0, 10.0, 10.0]]), "scores": torch.tensor([0.9]),
        ...           "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[0.0, 0.0, 10.0, 8.0]]), "labels": torch.tensor([0])}]
        >>> metric = CompleteIntersectionOverUnion(device="cpu")
        >>> metric.update(preds, target)
        >>> print(f"{float(metric.compute()['ciou']):.4f}")
        0.7949
    """

    _iou_type = "ciou"
    _invalid_val = -2.0  # CIoU can be below -1
    _pairwise_fn = staticmethod(complete_box_iou)
