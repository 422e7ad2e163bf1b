"""Box overlaps: IoU, GIoU, DIoU, CIoU (counterpart of ``torchmetrics_tpu/functional/detection/iou.py``).

Broadcast corner algebra over ``(..., N, 4)`` x ``(..., M, 4)`` boxes in float32, on the boxes' device
(a tensor's own; numpy inputs go to CUDA unless ``device`` names another). The formulas are the published
ones with torchvision's semantics, eps = 1e-7 for the distance and complete variants.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import resolve_device

_EPS = 1e-7


def _boxes(x, device=None) -> Tensor:
    """Boxes as float32: a tensor on its own device (or ``device``), anything else on ``device``."""
    if isinstance(x, Tensor):
        return x.to(device=x.device if device is None else device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))


def box_convert(boxes, in_fmt: str, out_fmt: str = "xyxy") -> Tensor:
    """Convert ``xywh`` or ``cxcywh`` boxes to ``xyxy`` (JAX ``iou.py:19``)."""
    boxes = _boxes(boxes)
    if in_fmt == out_fmt:
        return boxes
    if out_fmt != "xyxy":
        raise ValueError(f"Only conversion to 'xyxy' is supported, got {out_fmt}")
    if in_fmt == "xywh":
        x, y, w, h = boxes.unbind(-1)
        return torch.stack([x, y, x + w, y + h], dim=-1)
    if in_fmt == "cxcywh":
        cx, cy, w, h = boxes.unbind(-1)
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    raise ValueError(f"Unknown box format {in_fmt}")


def box_area(boxes) -> Tensor:
    boxes = _boxes(boxes)
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _pairwise_inter_union(preds: Tensor, target: Tensor):
    lt = torch.maximum(preds[..., :, None, :2], target[..., None, :, :2])
    rb = torch.minimum(preds[..., :, None, 2:], target[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(preds)[..., :, None] + box_area(target)[..., None, :] - inter
    return inter, union


def _pair(preds, target):
    preds = _boxes(preds)
    return preds, _boxes(target, preds.device)


def box_iou(preds, target) -> Tensor:
    """The pairwise IoU matrix ``(N, M)`` of ``xyxy`` boxes."""
    inter, union = _pairwise_inter_union(*_pair(preds, target))
    return inter / union


def _enclosing_wh(preds: Tensor, target: Tensor) -> Tensor:
    lt = torch.minimum(preds[..., :, None, :2], target[..., None, :, :2])
    rb = torch.maximum(preds[..., :, None, 2:], target[..., None, :, 2:])
    return torch.clamp(rb - lt, min=0.0)


def generalized_box_iou(preds, target) -> Tensor:
    """The pairwise GIoU: IoU less the share of the enclosing box that the union leaves uncovered."""
    preds, target = _pair(preds, target)
    inter, union = _pairwise_inter_union(preds, target)
    iou = inter / union
    wh = _enclosing_wh(preds, target)
    enclose = wh[..., 0] * wh[..., 1]
    return iou - (enclose - union) / enclose


def _diou_terms(preds: Tensor, target: Tensor):
    """The shared DIoU geometry: the eps-stabilised IoU and the centre-distance penalty."""
    inter, union = _pairwise_inter_union(preds, target)
    iou = inter / (union + _EPS)
    wh = _enclosing_wh(preds, target)
    diag_sq = torch.square(wh[..., 0]) + torch.square(wh[..., 1]) + _EPS
    cp = (preds[..., :2] + preds[..., 2:]) / 2
    ct = (target[..., :2] + target[..., 2:]) / 2
    dist_sq = torch.sum(torch.square(cp[..., :, None, :] - ct[..., None, :, :]), dim=-1)
    return iou, dist_sq / diag_sq


def distance_box_iou(preds, target) -> Tensor:
    """The pairwise DIoU: IoU less the normalised centre distance."""
    iou, penalty = _diou_terms(*_pair(preds, target))
    return iou - penalty


def complete_box_iou(preds, target) -> Tensor:
    """The pairwise CIoU: DIoU less the aspect-ratio consistency term."""
    preds, target = _pair(preds, target)
    iou, penalty = _diou_terms(preds, target)
    wp = preds[..., 2] - preds[..., 0]
    hp = preds[..., 3] - preds[..., 1]
    wt = target[..., 2] - target[..., 0]
    ht = target[..., 3] - target[..., 1]
    v = (4 / math.pi**2) * torch.square(torch.arctan(wt / ht)[..., None, :] - torch.arctan(wp / hp)[..., :, None])
    alpha = v / (1 - iou + v + _EPS)
    return iou - penalty - alpha * v


def _masked_mean_diag(iou: Tensor) -> Tensor:
    if iou.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=iou.device)
    return torch.mean(torch.diagonal(iou, dim1=-2, dim2=-1))


def _make_functional(pairwise_fn, name: str):
    def fn(preds, target, iou_threshold: Optional[float] = None, replacement_val: float = 0,
           aggregate: bool = True) -> Tensor:
        iou = pairwise_fn(preds, target)
        if iou_threshold is not None:
            iou = torch.where(iou < iou_threshold, torch.full((), float(replacement_val), device=iou.device), iou)
        return _masked_mean_diag(iou) if aggregate else iou

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__doc__ = (
        f"{name} over xyxy box pairs (JAX ``functional/detection/iou.py``): the mean of the matrix's"
        " diagonal, or the whole matrix with ``aggregate=False``; on the boxes' device."
    )
    return fn


intersection_over_union = _make_functional(box_iou, "intersection_over_union")
generalized_intersection_over_union = _make_functional(generalized_box_iou, "generalized_intersection_over_union")
distance_intersection_over_union = _make_functional(distance_box_iou, "distance_intersection_over_union")
complete_intersection_over_union = _make_functional(complete_box_iou, "complete_intersection_over_union")
