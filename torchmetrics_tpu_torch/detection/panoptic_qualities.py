"""Panoptic quality module metrics (counterpart of ``torchmetrics_tpu/detection/panoptic_qualities.py``).

Per-category IoU sums (float32) and TP/FP/FN counts (int64, where JAX counts in int32), all
``dist_reduce_fx="sum"``; the segment matching runs on the host (``functional/detection/panoptic.py``).
"""
from __future__ import annotations

from typing import Any, Collection, Dict

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.detection.panoptic import (
    _as_input,
    _get_category_id_to_continuous_id,
    _get_void_color,
    _panoptic_quality_compute,
    _panoptic_quality_update,
    _parse_categories,
    _preprocess_inputs,
    _validate_inputs,
)
from torchmetrics_tpu_torch.metric import Metric


class PanopticQuality(Metric):
    """PQ over (category, instance) maps (JAX ``panoptic_qualities.py:20``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import PanopticQuality
        >>> preds = torch.tensor([[[6, 0], [0, 0], [6, 0], [7, 0]]])
        >>> target = torch.tensor([[[6, 0], [0, 1], [6, 0], [7, 0]]])
        >>> metric = PanopticQuality(things={6, 7}, stuffs={0}, device="cpu")
        >>> metric.update(preds, target)
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    jit_update = False  # the matching reads the maps on the host

    _modified_stuffs = False

    def __init__(self, things: Collection[int], stuffs: Collection[int], allow_unknown_preds_category: bool = False,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        things_p, stuffs_p = _parse_categories(things, stuffs)
        self.things = things_p
        self.stuffs = stuffs_p
        self.void_color = _get_void_color(things_p, stuffs_p)
        self.cat_id_to_continuous_id = _get_category_id_to_continuous_id(things_p, stuffs_p)
        self.allow_unknown_preds_category = allow_unknown_preds_category
        num_categories = len(things_p) + len(stuffs_p)
        self.add_state("iou_sum", torch.zeros(num_categories, dtype=torch.float32), dist_reduce_fx="sum")
        for name in ("true_positives", "false_positives", "false_negatives"):
            self.add_state(name, torch.zeros(num_categories, dtype=torch.int64), dist_reduce_fx="sum")

    def _coerce(self, args: tuple, kwargs: dict) -> tuple:
        """The maps as int64 tensors: a tensor where it is, numpy on the metric's device."""
        return tuple(_as_input(a, self.device) for a in args), kwargs

    def _update(self, state: Dict[str, Tensor], preds: Tensor, target: Tensor) -> Dict[str, Tensor]:
        _validate_inputs(preds, target)
        flat_preds = _preprocess_inputs(self.things, self.stuffs, preds, self.void_color,
                                        self.allow_unknown_preds_category)
        flat_target = _preprocess_inputs(self.things, self.stuffs, target, self.void_color, True)
        iou_sum, tp, fp, fn = _panoptic_quality_update(
            flat_preds, flat_target, self.cat_id_to_continuous_id, self.void_color,
            modified_metric_stuffs=self.stuffs if self._modified_stuffs else None, device=self.device,
        )
        return {
            "iou_sum": state["iou_sum"] + iou_sum,
            "true_positives": state["true_positives"] + tp,
            "false_positives": state["false_positives"] + fp,
            "false_negatives": state["false_negatives"] + fn,
        }

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        return _panoptic_quality_compute(state["iou_sum"], state["true_positives"], state["false_positives"],
                                         state["false_negatives"])


class ModifiedPanopticQuality(PanopticQuality):
    """Modified PQ: the stuffs scored without segment matching (JAX ``panoptic_qualities.py:90``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import ModifiedPanopticQuality
        >>> preds = torch.tensor([[[6, 0], [0, 0], [6, 0], [7, 0]]])
        >>> target = torch.tensor([[[6, 0], [0, 1], [6, 0], [7, 0]]])
        >>> metric = ModifiedPanopticQuality(things={6, 7}, stuffs={0}, device="cpu")
        >>> metric.update(preds, target)
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    _modified_stuffs = True
