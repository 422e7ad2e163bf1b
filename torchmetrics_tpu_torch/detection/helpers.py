"""Detection input validation (counterpart of ``torchmetrics_tpu/detection/helpers.py``).

A field spec per side (the required keys, which must share their leading dimension), checked by one
pass, with JAX's messages.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

_GEOMETRY_KEY = {"bbox": "boxes", "segm": "masks"}


def _leading_dim(x) -> int:
    shape = tuple(x.shape) if hasattr(x, "shape") else np.shape(x)
    return int(shape[0]) if shape else 0


def _check_sample_dicts(side: str, samples: Sequence[Dict], required: Tuple[str, ...], check_lengths: bool = True) -> None:
    """Every sample dict carries the ``required`` keys; with ``check_lengths`` those fields agree on
    their number of instances (their leading dimension)."""
    for key in required:
        if any(key not in sample for sample in samples):
            raise ValueError(f"Expected all dicts in `{side}` to contain the `{key}` key")
    if not check_lengths:
        return
    for i, sample in enumerate(samples):
        lengths = {key: _leading_dim(sample[key]) for key in required}
        if len(set(lengths.values())) > 1:
            detail = ", ".join(f"{k}={n}" for k, n in lengths.items())
            raise ValueError(f"Fields of sample {i} in `{side}` disagree on the number of instances ({detail})")


def _input_validator(
    preds: Sequence[Dict],
    targets: Sequence[Dict],
    iou_type: Union[str, Tuple[str, ...]] = "bbox",
    ignore_score: bool = False,
) -> None:
    """The list-of-dicts contract of the detection inputs (JAX ``helpers.py:46``)."""
    iou_types = (iou_type,) if isinstance(iou_type, str) else tuple(iou_type)
    unknown = [tp for tp in iou_types if tp not in _GEOMETRY_KEY]
    if unknown:
        raise Exception(f"IOU type {iou_types} is not supported")
    geometry = tuple(_GEOMETRY_KEY[tp] for tp in iou_types)
    for side, value in (("preds", preds), ("target", targets)):
        if not isinstance(value, Sequence):
            raise ValueError(f"Expected argument `{side}` to be of type Sequence, but got {value}")
    if len(preds) != len(targets):
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same length, but got {len(preds)} and {len(targets)}"
        )
    # with ignore_score the reference checks that the preds' keys are there, not their lengths
    pred_fields = geometry + (("labels",) if ignore_score else ("labels", "scores"))
    _check_sample_dicts("preds", preds, pred_fields, check_lengths=not ignore_score)
    _check_sample_dicts("target", targets, geometry + ("labels",))


def _fix_empty_boxes(boxes, device: torch.device) -> Tensor:
    """Boxes as float32 on ``device``, empty inputs as shape (0, 4) (JAX ``helpers.py:72``)."""
    boxes = boxes.to(device=device, dtype=torch.float32) if isinstance(boxes, Tensor) else torch.as_tensor(
        np.asarray(boxes, np.float32), device=device)
    if boxes.numel() == 0:
        return boxes.reshape(0, 4)
    return boxes
