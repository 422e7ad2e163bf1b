"""Panoptic quality (counterpart of ``torchmetrics_tpu/functional/detection/panoptic.py``).

The input preprocessing (flatten, the stuffs' instance ids zeroed, unknown categories to the void colour)
runs on the inputs' device, as JAX's does. JAX then takes one ``np.unique`` of fused (pred, target) colour
codes per sample on the host, about 0.1 s for a 480 x 640 map; the port takes the same intersection areas
for a whole batch from two ``torch.unique`` calls on the device (``_pair_tables``) and copies only the pair
tables to the host, where the data-dependent, ragged segment matching runs image by image in JAX's order,
so that every count and IoU sum is JAX's. The per-category sums live on the metric's device, and the
compute is tensor code there.
"""
from __future__ import annotations

from typing import Collection, Dict, Optional, Set, Tuple

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import resolve_device


def _parse_categories(things: Collection[int], stuffs: Collection[int]) -> Tuple[Set[int], Set[int]]:
    """JAX ``panoptic.py:20``."""
    things_parsed = set(int(t) for t in things)
    stuffs_parsed = set(int(s) for s in stuffs)
    if not things_parsed and not stuffs_parsed:
        raise ValueError("At least one of `things` and `stuffs` must be non-empty.")
    if things_parsed & stuffs_parsed:
        raise ValueError(
            f"Expected arguments `things` and `stuffs` to have distinct keys, but got {things} and {stuffs}"
        )
    return things_parsed, stuffs_parsed


def _get_void_color(things: Set[int], stuffs: Set[int]) -> Tuple[int, int]:
    """An unused (category, instance) colour (JAX ``panoptic.py:33``)."""
    return 1 + max([0, *things, *stuffs]), 0


def _get_category_id_to_continuous_id(things: Set[int], stuffs: Set[int]) -> Dict[int, int]:
    """Things first, then stuffs, each in its set's order (JAX ``panoptic.py:38``)."""
    mapping = {thing_id: idx for idx, thing_id in enumerate(things)}
    mapping.update({stuff_id: idx + len(things) for idx, stuff_id in enumerate(stuffs)})
    return mapping


def _as_input(x, device=None) -> Tensor:
    """A panoptic map as an int64 tensor: a tensor on its own device, anything else on ``device``."""
    if isinstance(x, Tensor):
        return x.to(torch.int64)
    return torch.as_tensor(np.asarray(x), device=resolve_device(device)).to(torch.int64)


def _validate_inputs(preds: Tensor, target: Tensor) -> None:
    """JAX ``panoptic.py:45``."""
    if preds.shape != target.shape:
        raise ValueError(
            "Expected argument `preds` and `target` to have the same shape, but got"
            f" {tuple(preds.shape)} and {tuple(target.shape)}"
        )
    if preds.ndim < 3:
        raise ValueError(
            "Expected argument `preds` to have at least one spatial dimension (B, *spatial_dims, 2),"
            f" got {tuple(preds.shape)}"
        )
    if preds.shape[-1] != 2:
        raise ValueError(
            f"Expected argument `preds` to have exactly 2 channels in the last dimension, got {tuple(preds.shape)}"
        )


def _preprocess_inputs(
    things: Set[int], stuffs: Set[int], inputs: Tensor, void_color: Tuple[int, int], allow_unknown_category: bool,
) -> Tensor:
    """Flatten the spatial dims, zero the stuffs' instance ids, map unknown categories to the void colour
    (JAX ``panoptic.py:62``); raises on an unknown category unless allowed."""
    out = inputs.to(torch.int64).reshape(inputs.shape[0], -1, 2)
    cats = out[:, :, 0]
    mask_stuffs = torch.isin(cats, torch.tensor(sorted(stuffs), dtype=torch.int64, device=cats.device))
    mask_things = torch.isin(cats, torch.tensor(sorted(things), dtype=torch.int64, device=cats.device))
    known = mask_things | mask_stuffs
    if not allow_unknown_category and not bool(torch.all(known)):
        raise ValueError(f"Unknown categories found: {np.unique(cats[~known].cpu().numpy())}")
    inst = torch.where(mask_stuffs, 0, out[:, :, 1])
    cats = torch.where(known, cats, void_color[0])
    inst = torch.where(known, inst, void_color[1])
    return torch.stack([cats, inst], dim=-1)


def _pair_tables(flat_preds: Tensor, flat_target: Tensor, void_color: Tuple[int, int]):
    """Every (pred colour, target colour) pair of a batch with its area, from two ``torch.unique`` calls on
    the maps' device; one copy of the tables to the host.

    Each image's colours are fused into one int64 code with its index, ``(b, category, instance)`` in
    lexicographic order (the void colour joins every image's palette, as in JAX), and compacted to dense
    ids, so that the pair codes cannot overflow whatever the instance ids. Returns, on the host, each
    dense colour's (image, category) and each pair's (pred id, target id, area), pairs sorted by (pred,
    target): the order of JAX's ``np.unique`` of its pair codes within an image.
    """
    n_img = flat_preds.shape[0]
    maxima = torch.stack([flat_preds.amax() if flat_preds.numel() else flat_preds.new_zeros(()),
                          flat_target.amax() if flat_target.numel() else flat_target.new_zeros(())])
    id_base = 1 + max(int(maxima.max()), void_color[0], void_color[1])
    span = id_base * id_base
    offset = torch.arange(n_img, device=flat_preds.device, dtype=torch.int64)[:, None] * span
    p_raw = flat_preds[..., 0].to(torch.int64) * id_base + flat_preds[..., 1] + offset
    t_raw = flat_target[..., 0].to(torch.int64) * id_base + flat_target[..., 1] + offset
    void_raw = void_color[0] * id_base + void_color[1] + offset[:, 0]
    palette, dense = torch.unique(torch.cat([p_raw.reshape(-1), t_raw.reshape(-1), void_raw]), return_inverse=True)
    k = palette.shape[0]
    n_pix = p_raw.numel()
    pairs, areas = torch.unique(dense[:n_pix] * k + dense[n_pix:2 * n_pix], return_counts=True)
    palette, pairs, areas = (x.cpu().numpy() for x in (palette, pairs, areas))
    colour = palette % span
    return palette // span, colour // id_base, pairs // k, pairs % k, areas


def _panoptic_quality_update_sample(
    pair_p: np.ndarray,
    pair_t: np.ndarray,
    pair_areas: np.ndarray,
    cat_of_dense: np.ndarray,
    void_code: int,
    cat_id_to_continuous_id: Dict[int, int],
    stuffs_modified_metric: Optional[Set[int]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One sample's IoU sums and TP/FP/FN per category from its pair table (JAX ``panoptic.py:86``, whose
    ``np.unique`` of fused codes gives the same table): the segments' areas are the sums of their pairs',
    and the matching at IoU > 0.5 visits the pairs in JAX's order."""
    stuffs_modified_metric = stuffs_modified_metric or set()
    num_categories = len(cat_id_to_continuous_id)
    iou_sum = np.zeros(num_categories)
    tp = np.zeros(num_categories, np.int64)
    fp = np.zeros(num_categories, np.int64)
    fn = np.zeros(num_categories, np.int64)

    p_area_of: Dict[int, int] = {}
    t_area_of: Dict[int, int] = {}
    p_void: Dict[int, int] = {}
    t_void: Dict[int, int] = {}
    for p, t, a in zip(pair_p.tolist(), pair_t.tolist(), pair_areas.tolist()):
        p_area_of[p] = p_area_of.get(p, 0) + a
        t_area_of[t] = t_area_of.get(t, 0) + a
        if t == void_code:
            p_void[p] = a
        if p == void_code:
            t_void[t] = a

    pred_matched: set = set()
    target_matched: set = set()
    for p_c, t_c, inter in zip(pair_p.tolist(), pair_t.tolist(), pair_areas.tolist()):
        if t_c == void_code or p_c == void_code:
            continue
        p_cat, t_cat = int(cat_of_dense[p_c]), int(cat_of_dense[t_c])
        if p_cat != t_cat:
            continue
        union = p_area_of[p_c] - p_void.get(p_c, 0) + t_area_of[t_c] - t_void.get(t_c, 0) - inter
        iou = inter / union
        cid = cat_id_to_continuous_id[t_cat]
        if t_cat not in stuffs_modified_metric and iou > 0.5:
            pred_matched.add(p_c)
            target_matched.add(t_c)
            iou_sum[cid] += iou
            tp[cid] += 1
        elif t_cat in stuffs_modified_metric and iou > 0:
            iou_sum[cid] += iou

    for t_c in sorted(t_area_of):
        area = t_area_of[t_c]
        if t_c == void_code or t_c in target_matched:
            continue
        cat = int(cat_of_dense[t_c])
        if cat in stuffs_modified_metric:
            continue
        if t_void.get(t_c, 0) / area <= 0.5:
            fn[cat_id_to_continuous_id[cat]] += 1

    for p_c in sorted(p_area_of):
        area = p_area_of[p_c]
        if p_c == void_code or p_c in pred_matched:
            continue
        cat = int(cat_of_dense[p_c])
        if cat in stuffs_modified_metric:
            continue
        if p_void.get(p_c, 0) / area <= 0.5:
            fp[cat_id_to_continuous_id[cat]] += 1

    # modified PQ's stuffs: the TP slot counts target segments
    for t_c in sorted(t_area_of):
        if t_c == void_code:
            continue
        cat = int(cat_of_dense[t_c])
        if cat in stuffs_modified_metric:
            tp[cat_id_to_continuous_id[cat]] += 1

    return iou_sum, tp, fp, fn


#: the most pixels of one ``_pair_tables`` call: its sorts take several int64 copies of them
PAIR_CHUNK_PIXELS = 1 << 24


def _panoptic_quality_update(
    flatten_preds: Tensor,
    flatten_target: Tensor,
    cat_id_to_continuous_id: Dict[int, int],
    void_color: Tuple[int, int],
    modified_metric_stuffs: Optional[Set[int]] = None,
    device: Optional[torch.device] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """A batch's per-category sums (segments never match across samples; JAX ``panoptic.py:160``): the
    pair tables from the maps' device, for at most ``PAIR_CHUNK_PIXELS`` pixels at a time, the matching on
    the host, image by image, the IoU sums added in float64 in image order; the IoU sums in float32 and the
    counts in int64 on ``device`` (the inputs' device by default)."""
    device = flatten_preds.device if device is None else device
    num_categories = len(cat_id_to_continuous_id)
    iou_sum = np.zeros(num_categories)
    counts = np.zeros((3, num_categories), np.int64)
    step = max(1, PAIR_CHUNK_PIXELS // max(1, flatten_preds.shape[1]))
    for start in range(0, flatten_preds.shape[0], step):
        chunk = (flatten_preds[start:start + step], flatten_target[start:start + step])
        image_of, cat_of, pair_p, pair_t, pair_areas = _pair_tables(*chunk, void_color)
        # the void category holds only the void colour after the preprocessing: one dense id per image
        voids = np.flatnonzero(cat_of == void_color[0])
        bounds = np.searchsorted(image_of[pair_p], np.arange(chunk[0].shape[0] + 1))
        for b in range(chunk[0].shape[0]):
            lo, hi = int(bounds[b]), int(bounds[b + 1])
            r = _panoptic_quality_update_sample(pair_p[lo:hi], pair_t[lo:hi], pair_areas[lo:hi], cat_of, int(voids[b]),
                                                cat_id_to_continuous_id, stuffs_modified_metric=modified_metric_stuffs)
            iou_sum += r[0]
            counts += np.stack(r[1:])
    counts_dev = torch.from_numpy(counts).to(device)
    return (torch.from_numpy(iou_sum.astype(np.float32)).to(device), counts_dev[0], counts_dev[1], counts_dev[2])


def _panoptic_quality_compute(iou_sum: Tensor, tp: Tensor, fp: Tensor, fn: Tensor) -> Tensor:
    """PQ, the mean over the observed categories of iou_sum / (TP + FP/2 + FN/2) (JAX ``panoptic.py:188``)."""
    denominator = tp.to(torch.float32) + 0.5 * fp + 0.5 * fn
    observed = denominator > 0
    pq = torch.where(observed, iou_sum / torch.where(observed, denominator, torch.ones_like(denominator)),
                     torch.zeros_like(denominator))
    return torch.sum(pq * observed) / torch.sum(observed)


def _panoptic(preds, target, things, stuffs, allow_unknown_preds_category: bool, modified: bool, device) -> Tensor:
    things_p, stuffs_p = _parse_categories(things, stuffs)
    preds, target = _as_input(preds, device), _as_input(target, device)
    _validate_inputs(preds, target)
    void_color = _get_void_color(things_p, stuffs_p)
    cat_map = _get_category_id_to_continuous_id(things_p, stuffs_p)
    fp_preds = _preprocess_inputs(things_p, stuffs_p, preds, void_color, allow_unknown_preds_category)
    fp_target = _preprocess_inputs(things_p, stuffs_p, target.to(preds.device), void_color, True)
    sums = _panoptic_quality_update(fp_preds, fp_target, cat_map, void_color,
                                    modified_metric_stuffs=stuffs_p if modified else None)
    return _panoptic_quality_compute(*sums)


def panoptic_quality(preds, target, things: Collection[int], stuffs: Collection[int],
                     allow_unknown_preds_category: bool = False, device=None) -> Tensor:
    """PQ (JAX ``panoptic.py:196``), on the inputs' device (numpy inputs: CUDA unless ``device`` names another).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import panoptic_quality
        >>> preds = torch.tensor([[[6, 0], [0, 0], [6, 0], [7, 0]]])
        >>> target = torch.tensor([[[6, 0], [0, 1], [6, 0], [7, 0]]])
        >>> print(f"{float(panoptic_quality(preds, target, things={6, 7}, stuffs={0})):.4f}")
        1.0000
    """
    return _panoptic(preds, target, things, stuffs, allow_unknown_preds_category, False, device)


def modified_panoptic_quality(preds, target, things: Collection[int], stuffs: Collection[int],
                              allow_unknown_preds_category: bool = False, device=None) -> Tensor:
    """Modified PQ: the stuffs scored by their IoU sum over target segments (JAX ``panoptic.py:224``)."""
    return _panoptic(preds, target, things, stuffs, allow_unknown_preds_category, True, device)
