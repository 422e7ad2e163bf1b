"""Mean average precision, COCO protocol (counterpart of ``torchmetrics_tpu/detection/mean_ap.py``).

As in JAX, every (image, class) group is padded into power-of-two buffers, and one greedy COCO matcher
runs every group x 4 area ranges x T IoU thresholds at once: a loop over the detection axis, the only
sequential one, with a masked first-index argmax over the ground truths inside. Ignored and crowd
ground truths are never matched, and detections go in score order.

Where each part runs:

- **The host** groups, sorts and pads (``_build_groups``: one stable sort of every detection by
  (class, image, score), not JAX's loop over classes and images, with the same groups in the same
  order), computes the area ranges' ignore masks, and accumulates precision and recall in numpy, as JAX
  does. It reads the labels, scores, crowd flags and areas once per compute.
- **The device** keeps the geometry: the boxes or masks stay where ``update`` put them, are gathered
  into the group buffers there, and give the IoU (box corner algebra, or for ``segm`` one ``bmm`` of
  0/1 float32 masks in IEEE float32, exact: the intersections are whole numbers below 2^24). The IoU
  stays on the device for the matcher. The host gets the ``(P, A, T, D)`` match table, each group's
  best crowd intersection-over-detection-area (``(P, D)``, only where crowds are present), and the IoU
  itself only under ``extended_summary``.
- **The matcher** runs the groups in blocks of a fixed number of rows on the graph tier: one captured
  CUDA graph per block shape ``(rows, D, G, A, T)`` (as JAX jits it once per shape), replayed for every
  block of this compute and of later ones, the last block padded with empty groups. ``rows`` is a power
  of two, at most ``MATCH_BLOCK_ELEMS`` matchable slots a block, so a large evaluation meets the same
  shape again whatever its number of groups, and the graph's memory is bounded. Each device keeps its
  last graph only. A failed capture raises. On the eager tier (``TM_TPU_FAST_DISPATCH=0``, the CPU) it
  runs step by step over every group at once. Both give the same bits: the groups are independent.

The mask product is chunked by padded elements (``_SEGM_CHUNK_ELEMS``), as in JAX: no global mask
tensor is formed; each group keeps only the rectangle that holds its masks' pixels. Labels and crowd flags are int64 here (JAX's int32 states load and compute the same).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.detection.helpers import _fix_empty_boxes, _input_validator
from torchmetrics_tpu_torch.functional.detection.iou import _pairwise_inter_union, box_area, box_convert
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.ops import dispatch
from torchmetrics_tpu_torch.utils.precision import full_float32

_AREA_RANGES = {
    "all": (0.0, 1e5**2),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e5**2),
}

#: the matcher's graph on each device, with its input signature: a new block shape replaces it
_MATCH_GRAPHS: Dict[torch.device, Tuple[Tuple, "dispatch.StepGraph"]] = {}
#: the (rows, A, T, G) slots of one block of the matcher's groups on the graph tier
MATCH_BLOCK_ELEMS = 1 << 24
#: the largest float32 block of the box IoU's temporaries, in bytes
BOX_BLOCK_BYTES = 1 << 30


def _validate_iou_types(iou_type: Union[str, Sequence[str]]) -> Tuple[str, ...]:
    types = (iou_type,) if isinstance(iou_type, str) else tuple(iou_type)
    if not types or any(t not in ("bbox", "segm") for t in types):
        raise ValueError(f"Expected argument `iou_type` to be one of ('bbox', 'segm') or a tuple of them, got {iou_type}")
    return types


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 2 ** int(np.ceil(np.log2(n)))


def _match_step(free: Tensor, iou_d: Tensor, det_valid_d: Tensor, thresholds: Tensor) -> Tensor:
    """One detection column of the greedy matcher (JAX ``mean_ap.py:70``): the best free matchable ground
    truth of each (group, area, threshold), first index on ties, matched where its IoU clears the threshold
    and the detection is real. ``free`` ``(P, A, T, G)`` holds the matchable ground truths not yet matched
    and loses the matched ones in place; ``iou_d`` is ``(P, G)``, ``det_valid_d`` ``(P,)``. Returns ``ok``
    ``(P, A, T)``. JAX's one-hot update of its matched set becomes one scatter at the chosen index."""
    masked = torch.where(free, iou_d[:, None, None, :], torch.zeros((), device=iou_d.device))
    m = torch.argmax(masked, dim=-1, keepdim=True)  # the first maximum, as jnp.argmax
    ok = (torch.gather(masked, -1, m)[..., 0] > thresholds[None, None, :]) & det_valid_d[:, None, None]
    free.scatter_(-1, m, torch.gather(free, -1, m) & ~ok[..., None])
    return ok


def _match_all_groups(ious: Tensor, det_valid: Tensor, gt_valid: Tensor, gt_ignore: Tensor,
                      thresholds: Tensor) -> Tensor:
    """Greedy COCO matching of every (group, area, threshold) (JAX ``mean_ap.py:52``), step by step.

    ``ious`` ``(P, D, G)`` with the detections in score order, ``det_valid`` ``(P, D)``, ``gt_valid``
    ``(P, G)``, ``gt_ignore`` ``(P, A, G)``, ``thresholds`` ``(T,)``; returns ``(P, A, T, D)`` bool. Reads
    nothing on the host, so it can be captured.
    """
    num_pairs, num_det, num_gt = ious.shape
    shape = (num_pairs, gt_ignore.shape[1], thresholds.shape[0], num_gt)
    free = (gt_valid[:, None, None, :] & ~gt_ignore[:, :, None, :]).expand(shape).clone()
    oks = [_match_step(free, ious[:, d, :], det_valid[:, d], thresholds) for d in range(num_det)]
    if not oks:
        return torch.zeros(shape[:3] + (0,), dtype=torch.bool, device=ious.device)
    return torch.stack(oks, dim=-1)


def _block_rows(x: Tensor, start: int, rows: int) -> Tensor:
    """Rows ``start:start + rows`` of ``x``, padded with zeros (no detection, no ground truth) past its end."""
    part = x[start:start + rows]
    if part.shape[0] == rows:
        return part
    out = x.new_zeros((rows,) + tuple(x.shape[1:]))
    out[:part.shape[0]] = part
    return out


def _match_graph(device: torch.device, block: tuple) -> "dispatch.StepGraph":
    """The device's matcher graph for ``block``, loaded with it: the kept one if its signature is the
    block's, else a new capture, which replaces it (the old graph's memory goes back first)."""
    key = dispatch.signature(block, {})
    kept = _MATCH_GRAPHS.get(device)
    if kept is not None and kept[0] == key:
        kept[1].load(block, {})
        return kept[1]
    kept = _MATCH_GRAPHS.pop(device, None)
    del kept
    static = tuple(a.clone() for a in block)
    step = dispatch.capture(device, lambda: (_match_all_groups(*static), {}), lambda new_state: None, static, {})
    _MATCH_GRAPHS[device] = (key, step)
    return step


def match_all_groups(ious: Tensor, det_valid: Tensor, gt_valid: Tensor, gt_ignore: Tensor,
                     thresholds: Tensor) -> Tensor:
    """:func:`_match_all_groups` on the tier the dispatch gate picks: on the graph tier, one graph replay per
    block of groups (the graph captured at the first block of a new shape; a failed capture raises), step
    by step over every group otherwise."""
    device = ious.device
    if not (dispatch.fast_dispatch_enabled() and dispatch.graph_device(device)):
        return _match_all_groups(ious, det_valid, gt_valid, gt_ignore, thresholds)
    num_pairs, num_det, num_gt = ious.shape
    slots = gt_ignore.shape[1] * thresholds.shape[0] * max(num_gt, 1)
    rows = min(_next_pow2(num_pairs), 1 << max(0, (MATCH_BLOCK_ELEMS // slots).bit_length() - 1))
    out = torch.empty((num_pairs, gt_ignore.shape[1], thresholds.shape[0], num_det), dtype=torch.bool, device=device)
    for start in range(0, num_pairs, rows):
        block = tuple(_block_rows(x, start, rows) for x in (ious, det_valid, gt_valid, gt_ignore)) + (thresholds,)
        step = _match_graph(device, block)
        step.replay()
        end = min(start + rows, num_pairs)
        out[start:end] = step.values()[:end - start]
    return out


def _box_iou_iod(det_buf: Tensor, gt_buf: Tensor) -> Tuple[Tensor, Tensor]:
    """``(P, D, 4)`` x ``(P, G, 4)`` boxes -> (iou, iod), each ``(P, D, G)`` (JAX ``mean_ap.py:105``)."""
    inter, union = _pairwise_inter_union(det_buf, gt_buf)
    zero = torch.zeros((), device=det_buf.device)
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-9), zero)
    area_d = box_area(det_buf)[..., :, None]
    iod = torch.where(area_d > 0, inter / torch.clamp(area_d, min=1e-9), zero)
    return iou, iod


#: the pixels of one slice of the mask product's reduction
MASK_SLICE = 4096


def _mask_iou_matrix(det_flat: Tensor, gt_flat: Tensor) -> Tuple[Tensor, Tensor]:
    """``(P, D, HW)`` x ``(P, G, HW)`` 0/1 masks -> (iou, iod), each ``(P, D, G)``, from one batched product
    in IEEE float32 (JAX ``mean_ap.py:87``, ``precision="highest"``): the intersections are whole numbers
    below 2^24, so exact. ``iod``, the intersection over the detection's area, is COCO's crowd IoU.

    The product's output is small (D x G a group) and its reduction long (HW), which leaves one batched
    GEMM with few tiles: the pixels are cut into slices of ``MASK_SLICE``, each slice one more member of the
    batch, and the slices' partial counts summed after. Every partial count is a whole number, so the sum
    is exact in any order."""
    det_f = det_flat.to(torch.float32)
    gt_f = gt_flat.to(torch.float32)
    area_d = torch.sum(det_f, dim=-1)
    area_g = torch.sum(gt_f, dim=-1)
    n, k = det_f.shape[0], det_f.shape[-1]
    slices = max(1, -(-k // MASK_SLICE))

    def sliced(x: Tensor) -> Tensor:
        if slices == 1:
            return x
        x = torch.nn.functional.pad(x, (0, slices * MASK_SLICE - k))
        return x.view(n, x.shape[1], slices, MASK_SLICE).transpose(1, 2).reshape(n * slices, x.shape[1], MASK_SLICE)

    with full_float32():
        inter = torch.bmm(sliced(det_f), sliced(gt_f).transpose(1, 2))
    inter = inter.view(n, slices, *inter.shape[1:]).sum(dim=1)
    union = area_d[:, :, None] + area_g[:, None, :] - inter
    zero = torch.zeros((), device=inter.device)
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1.0), zero)
    iod = torch.where(area_d[:, :, None] > 0, inter / torch.clamp(area_d[:, :, None], min=1.0), zero)
    return iou, iod


def _ranks(keys: np.ndarray, num_groups: int, group_keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Each sorted item's group and its rank within the group (``keys`` sorted by group)."""
    grp = np.searchsorted(group_keys, keys)
    counts = np.bincount(grp, minlength=num_groups)
    starts = np.cumsum(counts) - counts
    return grp, np.arange(keys.shape[0]) - starts[grp]


class _Groups:
    """The padded (image, class) groups of one compute: host arrays, and each slot's item index."""

    __slots__ = ("cls_of", "img_of", "scores", "det_valid", "det_item", "gt_valid", "gt_item", "gt_crowd",
                 "gt_area", "cap_d", "cap_g")


class MeanAveragePrecision(Metric):
    """mAP and mAR for object detection and instance segmentation (JAX ``mean_ap.py:118``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import MeanAveragePrecision
        >>> preds = [{"boxes": torch.tensor([[0.0, 0.0, 10.0, 10.0]]), "scores": torch.tensor([0.9]),
        ...           "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[0.0, 0.0, 10.0, 8.0]]), "labels": torch.tensor([0])}]
        >>> metric = MeanAveragePrecision(device="cpu")
        >>> metric.update(preds, target)
        >>> result = metric.compute()
        >>> print(f"{float(result['map']):.4f} {float(result['map_50']):.4f}")
        0.6000 1.0000
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    jit_update = False
    jit_compute = False

    #: the padded mask elements of one chunk of the mask product (bool, before the float32 copy)
    _SEGM_CHUNK_ELEMS = 1 << 28

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_type: Union[str, Tuple[str, ...]] = "bbox",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        extended_summary: bool = False,
        average: str = "macro",
        backend: str = "pycocotools",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Argument `box_format` must be one of {allowed_box_formats}, but got {box_format}")
        self.box_format = box_format
        self.iou_types = _validate_iou_types(iou_type)
        self.iou_type = iou_type
        self.iou_thresholds = list(iou_thresholds or np.linspace(0.5, 0.95, 10).round(2).tolist())
        self.rec_thresholds = list(rec_thresholds or np.linspace(0.0, 1.0, 101).round(2).tolist())
        self.max_detection_thresholds = sorted(int(x) for x in (max_detection_thresholds or [1, 10, 100]))
        if not isinstance(class_metrics, bool):
            raise ValueError('Argument `class_metrics` must be a boolean')
        self.class_metrics = class_metrics
        if not isinstance(extended_summary, bool):
            raise ValueError("Expected argument `extended_summary` to be a boolean")
        self.extended_summary = extended_summary
        if average not in ("macro", "micro"):
            raise ValueError(f"Argument `average` must be 'macro' or 'micro', but got {average}")
        self.average = average
        if backend not in ("pycocotools", "faster_coco_eval"):
            raise ValueError(f"Argument `backend` must be 'pycocotools' or 'faster_coco_eval', but got {backend}")
        self.backend = backend  # accepted as the reference's; the evaluation is the built-in matcher
        for name in ("detections", "detection_masks", "detection_scores", "detection_labels", "groundtruths",
                     "groundtruth_masks", "groundtruth_labels", "groundtruth_crowds", "groundtruth_area"):
            self.add_state(name, [], dist_reduce_fx=None)

    def update(self, preds: List[Dict[str, Any]], target: List[Dict[str, Any]]) -> None:  # noqa: D102
        self._guard_synced("update")
        _input_validator(preds, target, iou_type=self.iou_types)

        # the optional COCO fields are checked before any append, so that a failure leaves the lists aligned
        def _flat_len(v) -> int:
            shape = getattr(v, "shape", None)
            return int(np.prod(shape)) if shape is not None else len(v)

        for item in target:
            n_labels = _flat_len(item["labels"])
            for key in ("iscrowd", "area"):
                val = item.get(key)
                if val is not None and _flat_len(val) != n_labels:
                    raise ValueError(
                        f"Input '{key}' and labels of a sample in targets have different"
                        f" lengths ({_flat_len(val)} vs {n_labels})"
                    )
        lists, dev = self._state.lists, self.device
        for item in preds:
            if "bbox" in self.iou_types:
                lists["detections"].append(self._get_safe_item_values(item["boxes"]))
            if "segm" in self.iou_types:
                lists["detection_masks"].append(self._as(item["masks"], torch.bool))
            lists["detection_labels"].append(self._as(item["labels"], torch.int64).reshape(-1))
            lists["detection_scores"].append(self._as(item["scores"], torch.float32).reshape(-1))
        for item in target:
            if "bbox" in self.iou_types:
                lists["groundtruths"].append(self._get_safe_item_values(item["boxes"]))
            if "segm" in self.iou_types:
                lists["groundtruth_masks"].append(self._as(item["masks"], torch.bool))
            labels = self._as(item["labels"], torch.int64).reshape(-1)
            lists["groundtruth_labels"].append(labels)
            for key, dtype, state_name in (("iscrowd", torch.int64, "groundtruth_crowds"),
                                           ("area", torch.float32, "groundtruth_area")):
                val = item.get(key)
                lists[state_name].append(torch.zeros(labels.shape, dtype=dtype, device=dev) if val is None
                                         else self._as(val, dtype).reshape(-1))
        self._bump()

    def _as(self, x, dtype: torch.dtype) -> Tensor:
        t = x if isinstance(x, Tensor) else torch.as_tensor(np.asarray(x))
        return t.to(device=self.device, dtype=dtype)

    def _get_safe_item_values(self, boxes) -> Tensor:
        boxes = _fix_empty_boxes(boxes, self.device)
        if boxes.numel() > 0:
            boxes = box_convert(boxes, in_fmt=self.box_format, out_fmt="xyxy")
        return boxes

    def _update(self, state, *args, **kwargs):  # pragma: no cover - update() is overridden
        raise NotImplementedError

    # ------------------------------------------------------------------ host reads
    def _host_cat(self, name: str, dtype) -> Tuple[np.ndarray, np.ndarray]:
        """A list state's entries concatenated and read on the host once, and each entry's length."""
        entries = self._state.lists[name]
        lengths = np.asarray([int(e.reshape(-1).shape[0]) for e in entries], np.int64)
        if not entries:
            return np.zeros((0,), dtype), lengths
        return torch.cat([e.reshape(-1) for e in entries]).cpu().numpy().astype(dtype, copy=False), lengths

    def _get_classes(self) -> List[int]:
        det, _ = self._host_cat("detection_labels", np.int64)
        gt, _ = self._host_cat("groundtruth_labels", np.int64)
        if not len(self._state.lists["detection_labels"]) + len(self._state.lists["groundtruth_labels"]):
            return []
        return np.unique(np.concatenate([det, gt])).astype(np.int64).tolist()

    # ------------------------------------------------------------------ compute
    def _build_groups(self, classes: List[int], micro: bool = False) -> Optional[_Groups]:
        """Group the detections and ground truths by (class, image) in JAX's order (class outer, image
        inner), the detections of a group by descending score (stable) and cut to the largest
        ``max_detection_thresholds``, and pad each group to power-of-two capacities
        (JAX ``mean_ap.py:274``). ``micro=True`` merges every label into one class."""
        max_det = self.max_detection_thresholds[-1]
        d_labels, d_len = self._host_cat("detection_labels", np.int64)
        d_scores, _ = self._host_cat("detection_scores", np.float32)
        g_labels, g_len = self._host_cat("groundtruth_labels", np.int64)
        g_crowd, _ = self._host_cat("groundtruth_crowds", np.int64)
        g_area, _ = self._host_cat("groundtruth_area", np.float64)
        n_img = len(g_len)
        if micro:
            d_labels, g_labels = np.zeros_like(d_labels), np.zeros_like(g_labels)
        cls_arr = np.asarray(classes, np.int64)
        d_img = np.repeat(np.arange(len(d_len)), d_len)
        g_img = np.repeat(np.arange(n_img), g_len)
        # items of an image whose labels fall outside ``classes`` join no group, as in JAX's loop
        d_in = np.isin(d_labels, cls_arr) & (d_img < n_img)
        g_in = np.isin(g_labels, cls_arr)
        d_key = np.searchsorted(cls_arr, d_labels) * n_img + d_img
        g_key = np.searchsorted(cls_arr, g_labels) * n_img + g_img
        d_idx, g_idx = np.flatnonzero(d_in), np.flatnonzero(g_in)
        group_keys = np.unique(np.concatenate([d_key[d_idx], g_key[g_idx]]))
        if not group_keys.size:
            return None
        num = group_keys.size
        by_score = d_idx[np.argsort(-d_scores[d_idx], kind="stable")]
        d_order = by_score[np.argsort(d_key[by_score], kind="stable")]
        d_grp, d_rank = _ranks(d_key[d_order], num, group_keys)
        kept = d_rank < max_det
        d_order, d_grp, d_rank = d_order[kept], d_grp[kept], d_rank[kept]
        g_order = g_idx[np.argsort(g_key[g_idx], kind="stable")]
        g_grp, g_rank = _ranks(g_key[g_order], num, group_keys)
        g = _Groups()
        g.cap_d = _next_pow2(int(np.bincount(d_grp, minlength=num).max()))
        g.cap_g = _next_pow2(int(np.bincount(g_grp, minlength=num).max()))
        g.cls_of, g.img_of = group_keys // n_img, group_keys % n_img
        g.scores = np.full((num, g.cap_d), -np.inf, np.float32)
        g.det_valid = np.zeros((num, g.cap_d), bool)
        g.det_item = np.zeros((num, g.cap_d), np.int64)
        g.gt_valid = np.zeros((num, g.cap_g), bool)
        g.gt_item = np.zeros((num, g.cap_g), np.int64)
        g.gt_crowd = np.zeros((num, g.cap_g), bool)
        g.gt_area = np.zeros((num, g.cap_g), np.float64)
        g.scores[d_grp, d_rank] = d_scores[d_order]
        g.det_valid[d_grp, d_rank] = True
        g.det_item[d_grp, d_rank] = d_order
        g.gt_valid[g_grp, g_rank] = True
        g.gt_item[g_grp, g_rank] = g_order
        g.gt_crowd[g_grp, g_rank] = g_crowd[g_order].astype(bool)
        g.gt_area[g_grp, g_rank] = g_area[g_order]
        return g

    def _gather(self, name: str, items: np.ndarray, valid: np.ndarray) -> Tensor:
        """The ``(P, cap, 4)`` box buffers of a list state on the device: each slot's box, 0 in the pads."""
        entries = self._state.lists[name]
        flat = torch.cat(entries).reshape(-1, 4) if entries else torch.zeros((0, 4), device=self.device)
        if flat.shape[0] == 0:
            return torch.zeros(items.shape + (4,), device=self.device)
        idx = torch.from_numpy(items).to(self.device)
        keep = torch.from_numpy(valid).to(self.device)
        return torch.where(keep[..., None], flat[idx], torch.zeros((), device=self.device))

    def _box_ious(self, g: _Groups, need_iod: bool) -> Tuple[Tensor, Optional[Tensor]]:
        """The groups' box IoU (and IoD) on the device, in blocks of groups of at most ``BOX_BLOCK_BYTES``
        of temporaries (an elementwise computation: the blocks change no value)."""
        det_buf = self._gather("detections", g.det_item, g.det_valid)
        gt_buf = self._gather("groundtruths", g.gt_item, g.gt_valid)
        rows = max(1, BOX_BLOCK_BYTES // (16 * g.cap_d * g.cap_g))
        ious, iods = [], []
        for start in range(0, det_buf.shape[0], rows):
            iou, iod = _box_iou_iod(det_buf[start:start + rows], gt_buf[start:start + rows])
            ious.append(iou)
            if need_iod:
                iods.append(iod)
        return torch.cat(ious), (torch.cat(iods) if need_iod else None)

    @staticmethod
    def _mask_extents(masks: List[Tensor]) -> np.ndarray:
        """Each mask's rows and columns with pixels, ``(n, 4)`` as (first row, row past the last, first
        column, column past the last), ``(H, 0, W, 0)`` for an empty mask: computed on the device, one copy."""
        out = []
        for m in masks:
            if not m.shape[0]:
                continue
            rows, cols = m.any(2), m.any(1)
            h, w = rows.shape[1], cols.shape[1]
            has = rows.any(1)
            first = lambda x: x.to(torch.uint8).argmax(1)  # noqa: E731 - the first True
            out.append(torch.stack([torch.where(has, first(rows), h), torch.where(has, h - first(rows.flip(1)), 0),
                                    torch.where(has, first(cols), w), torch.where(has, w - first(cols.flip(1)), 0)], 1))
        return torch.cat(out).cpu().numpy() if out else np.zeros((0, 4), np.int64)

    def _mask_ious(self, g: _Groups, need_iod: bool) -> Tuple[Tensor, Optional[Tensor]]:
        """The groups' mask IoU (and IoD) on the device, chunked by padded elements as in JAX
        (``mean_ap.py:355-391``). Each group keeps only the rectangle that holds all of its masks' pixels
        (JAX keeps the whole image): the counts, and so the IoU, are the same, and a chunk holds more groups.
        Each chunk pads its groups to its own largest rectangle and the capacities."""
        det_masks, gt_masks = self._state.lists["detection_masks"], self._state.lists["groundtruth_masks"]
        extents = (self._mask_extents(det_masks), self._mask_extents(gt_masks))
        offsets = (np.cumsum([0] + [int(m.shape[0]) for m in det_masks]),
                   np.cumsum([0] + [int(m.shape[0]) for m in gt_masks]))
        num = g.cls_of.shape[0]
        counts = (g.det_valid.sum(axis=1), g.gt_valid.sum(axis=1))
        items = (g.det_item, g.gt_item)
        windows = np.zeros((num, 4), np.int64)  # (row, column, height, width) of each group's rectangle
        for j in range(num):
            ext = np.concatenate([e[it[j, :int(c[j])]] for e, it, c in zip(extents, items, counts)])
            r0, r1, c0, c1 = ext[:, 0].min(initial=1 << 30), ext[:, 1].max(initial=0), ext[:, 2].min(initial=1 << 30), \
                ext[:, 3].max(initial=0)
            windows[j] = (r0, c0, r1 - r0, c1 - c0) if r1 > r0 and c1 > c0 else (0, 0, 1, 1)

        out = torch.zeros((num, g.cap_d, g.cap_g), device=self.device)
        out_iod = torch.zeros((num, g.cap_d, g.cap_g), device=self.device) if need_iod else None
        start = 0
        while start < num:
            end, run_h, run_w = start, 1, 1
            while end < num:
                new_h, new_w = max(run_h, int(windows[end, 2])), max(run_w, int(windows[end, 3]))
                if end > start and (end - start + 1) * (g.cap_d + g.cap_g) * new_h * new_w > self._SEGM_CHUNK_ELEMS:
                    break
                run_h, run_w = new_h, new_w
                end += 1
            n = end - start
            bufs = tuple(torch.zeros((n, cap, run_h, run_w), dtype=torch.bool, device=self.device)
                         for cap in (g.cap_d, g.cap_g))
            for jj, j in enumerate(range(start, end)):
                i = int(g.img_of[j])
                r0, c0, h, w = (int(x) for x in windows[j])
                for buf, masks, it, count, off in zip(bufs, (det_masks, gt_masks), items, counts, offsets):
                    c = int(count[j])
                    if c:
                        local = torch.from_numpy(it[j, :c] - off[i]).to(self.device)
                        buf[jj, :c, :h, :w] = masks[i][:, r0:r0 + h, c0:c0 + w][local]
            iou, iod = _mask_iou_matrix(bufs[0].reshape(n, g.cap_d, -1), bufs[1].reshape(n, g.cap_g, -1))
            out[start:end] = iou
            if need_iod:
                out_iod[start:end] = iod
            start = end
        return out, out_iod

    def _areas(self, g: _Groups, i_type: str) -> Tuple[np.ndarray, np.ndarray]:
        """Each slot's geometry area in float64 (0 in the pads): box areas in float32 as JAX forms them,
        mask pixel counts."""
        def per_item(name: str) -> np.ndarray:
            entries = self._state.lists[name]
            if not entries:
                return np.zeros((0,), np.float64)
            if i_type == "bbox":
                return box_area(torch.cat(entries).reshape(-1, 4)).cpu().numpy().astype(np.float64)
            return torch.cat([m.flatten(1).sum(dim=1) for m in entries]).cpu().numpy().astype(np.float64)

        names = ("detections", "groundtruths") if i_type == "bbox" else ("detection_masks", "groundtruth_masks")
        out = []
        for name, items, valid in zip(names, (g.det_item, g.gt_item), (g.det_valid, g.gt_valid)):
            area = per_item(name)
            out.append(np.where(valid, area[items] if area.size else 0.0, 0.0))
        return out[0], out[1]

    def _compute_one_type(self, classes: List[int], i_type: str, micro: bool = False):
        """precision ``(T, R, K, A, M)``, recall ``(T, K, A, M)``, scores ``(T, R, K, A, M)`` and the ious
        dict of one iou type (JAX ``mean_ap.py:407``)."""
        num_t = len(self.iou_thresholds)
        num_r = len(self.rec_thresholds)
        num_k = len(classes)
        num_a = len(_AREA_RANGES)
        num_m = len(self.max_detection_thresholds)
        precision = -np.ones((num_t, num_r, num_k, num_a, num_m))
        recall = -np.ones((num_t, num_k, num_a, num_m))
        score_arr = -np.ones((num_t, num_r, num_k, num_a, num_m))
        ious_out: Dict[Tuple[int, int], Tensor] = {}
        if self.extended_summary:
            # the reference gives an entry for every (image, class) pair; pairs with no group are empty
            num_imgs = len(self._state.lists["detection_labels"])
            empty = torch.zeros((0, 0), device=self.device)
            ious_out = {(i, c): empty for i in range(num_imgs) for c in classes}

        g = self._build_groups(classes, micro=micro) if classes else None
        if g is None:
            return precision, recall, score_arr, ious_out
        need_iod = bool((g.gt_crowd & g.gt_valid).any())
        ious_dev, iod_dev = (self._box_ious if i_type == "bbox" else self._mask_ious)(g, need_iod)
        det_valid = torch.from_numpy(g.det_valid).to(self.device)
        gt_valid = torch.from_numpy(g.gt_valid).to(self.device)
        ious = torch.where(det_valid[:, :, None] & gt_valid[:, None, :], ious_dev, torch.zeros((), device=self.device))
        if self.extended_summary:
            n_det, n_gt = g.det_valid.sum(axis=1), g.gt_valid.sum(axis=1)
            for j in range(ious_dev.shape[0]):
                ious_out[(int(g.img_of[j]), classes[int(g.cls_of[j])])] = ious_dev[j, :int(n_det[j]), :int(n_gt[j])]
        det_areas, gt_areas = self._areas(g, i_type)
        # explicit COCO annotation areas override the geometry's when positive
        gt_areas = np.where(g.gt_area > 0, g.gt_area, gt_areas)
        ranges = np.asarray(list(_AREA_RANGES.values()))  # (A, 2)
        # crowd ground truths are ignore-targets in every area range (pycocotools _ignore)
        gt_ignore = (
            (gt_areas[:, None, :] < ranges[None, :, 0:1]) | (gt_areas[:, None, :] > ranges[None, :, 1:2])
            | g.gt_crowd[:, None, :]
        )  # (P, A, G)
        det_outside = (det_areas[:, None, :] < ranges[None, :, 0:1]) | (det_areas[:, None, :] > ranges[None, :, 1:2])
        thresholds = torch.tensor(self.iou_thresholds, dtype=torch.float32, device=self.device)
        matches = match_all_groups(ious, det_valid, gt_valid, torch.from_numpy(gt_ignore).to(self.device),
                                   thresholds)  # (P, A, T, D)
        # crowd absorption (pycocotools' iscrowd): an unmatched detection whose intersection over its own
        # area with a crowd ground truth clears the threshold is ignored, not a false positive. The best
        # crowd IoD is reduced on the device, and the detections to ignore are formed there: the host gets
        # the two (P, A, T, D) tables the accumulation reads.
        crowd_mask = g.gt_crowd & g.gt_valid
        absorb = torch.zeros((g.det_valid.shape[0], num_t, g.det_valid.shape[1]), dtype=torch.bool, device=self.device)
        if iod_dev is not None and crowd_mask.any():
            crowd_dev = torch.from_numpy(crowd_mask).to(self.device)
            best_crowd_iod = torch.where(crowd_dev[:, None, :], iod_dev, torch.zeros((), device=self.device)).amax(dim=-1)
            # pycocotools compares with min(t, 1-1e-10): iod >= t absorbs; the matcher keeps the strict >
            thr = torch.tensor(self.iou_thresholds, dtype=torch.float64, device=self.device) - 1e-10
            absorb = best_crowd_iod.double()[:, None, :] > thr[None, :, None]  # (P, T, D)
        outside = torch.from_numpy(det_outside).to(self.device)
        ignore = ~matches & (outside[:, :, None, :] | absorb[:, None, :, :]) & det_valid[:, None, None, :]
        det_matches, det_ignore = matches.cpu().numpy(), ignore.cpu().numpy()
        self._accumulate(g, det_matches, det_ignore, gt_ignore, num_k, precision, recall, score_arr)
        return precision, recall, score_arr, ious_out

    def _accumulate(self, g: _Groups, det_matches: np.ndarray, det_ignore: np.ndarray, gt_ignore: np.ndarray,
                    num_k: int, precision: np.ndarray, recall: np.ndarray, score_arr: np.ndarray) -> None:
        """The precision/recall accumulation in numpy (JAX ``mean_ap.py:489-536``), into the arrays given.
        The groups are sorted by class, so each class's are one run of rows."""
        num_t = len(self.iou_thresholds)
        num_r = len(self.rec_thresholds)
        rec_thrs = np.asarray(self.rec_thresholds)
        eps = np.finfo(np.float64).eps
        bounds = np.searchsorted(g.cls_of, np.arange(num_k + 1))
        for k in range(num_k):
            sel = slice(int(bounds[k]), int(bounds[k + 1]))
            if sel.start == sel.stop:
                continue
            g_scores, g_valid = g.scores[sel], g.det_valid[sel]
            g_matches, g_ignore = det_matches[sel], det_ignore[sel]
            g_gt_valid, g_gt_ignore = g.gt_valid[sel], gt_ignore[sel]
            for a in range(len(_AREA_RANGES)):
                npig = int((g_gt_valid & ~g_gt_ignore[:, a]).sum())
                if npig == 0:
                    continue
                for mi, max_det in enumerate(self.max_detection_thresholds):
                    keep = g_valid[:, :max_det]
                    flat_scores = g_scores[:, :max_det][keep]
                    order = np.argsort(-flat_scores, kind="stable")
                    sorted_scores = flat_scores[order]
                    matches = g_matches[:, a, :, :max_det]
                    ignore = g_ignore[:, a, :, :max_det]
                    tps_all = matches.transpose(1, 0, 2)[:, keep][:, order]  # (T, N) in global score order
                    ign_all = ignore.transpose(1, 0, 2)[:, keep][:, order]
                    tps = tps_all & ~ign_all
                    fps = ~tps_all & ~ign_all
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(num_t):
                        tp, fp = tp_sum[t], fp_sum[t]
                        tp_len = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + eps)
                        recall[t, k, a, mi] = rc[-1] if tp_len else 0
                        # the monotone precision envelope (the reference's zigzag loop's fixpoint)
                        pr = np.maximum.accumulate(pr[::-1])[::-1]
                        prec = np.zeros(num_r)
                        scr = np.zeros(num_r)
                        inds = np.searchsorted(rc, rec_thrs, side="left")
                        num_inds = int(inds.argmax()) if (tp_len == 0 or inds.max() >= tp_len) else num_r
                        inds = inds[:num_inds]
                        prec[:num_inds] = pr[inds]
                        scr[:num_inds] = sorted_scores[inds] if tp_len else 0
                        precision[t, :, k, a, mi] = prec
                        score_arr[t, :, k, a, mi] = scr

    def _compute(self, state: Dict[str, Any]) -> Dict[str, Any]:
        classes = self._get_classes()
        num_k = len(classes)
        micro = self.average == "micro"
        results: Dict[str, Any] = {}
        for i_type in self.iou_types:
            prefix = "" if len(self.iou_types) == 1 else f"{i_type}_"
            # micro averaging merges every label into one class for the headline numbers; the
            # per-class numbers below are always macro
            eval_classes = [0] if micro and classes else classes
            precision, recall, score_arr, ious_out = self._compute_one_type(eval_classes, i_type, micro=micro)
            results.update({f"{prefix}{k}": v for k, v in self._summarize_results(precision, recall).items()})
            map_per_class = np.asarray([-1.0], np.float32)
            mar_per_class = np.asarray([-1.0], np.float32)
            if self.class_metrics and num_k:
                m_precision, m_recall, _, _ = (
                    self._compute_one_type(classes, i_type) if micro else (precision, recall, None, None)
                )
                maps, mars = [], []
                for k in range(num_k):
                    cls_res = self._summary_values(m_precision[:, :, k:k + 1], m_recall[:, k:k + 1])
                    maps.append(cls_res["map"])
                    mars.append(cls_res[f"mar_{self.max_detection_thresholds[-1]}"])
                map_per_class = np.asarray(maps, np.float32)
                mar_per_class = np.asarray(mars, np.float32)
            results[f"{prefix}map_per_class"] = torch.from_numpy(map_per_class).to(self.device)
            results[f"{prefix}mar_{self.max_detection_thresholds[-1]}_per_class"] = torch.from_numpy(
                mar_per_class).to(self.device)
            if self.extended_summary:
                results[f"{prefix}ious"] = ious_out
                for key, arr in (("precision", precision), ("recall", recall), ("scores", score_arr)):
                    results[f"{prefix}{key}"] = torch.from_numpy(arr.astype(np.float32)).to(self.device)
        results["classes"] = torch.tensor(classes, dtype=torch.int64, device=self.device)
        return results

    def _summarize(self, precision: np.ndarray, recall: np.ndarray, avg_prec: bool,
                   iou_threshold: Optional[float] = None, area_range: str = "all", max_dets: int = 100) -> float:
        """The mean over the valid (> -1) entries of the slice asked for (JAX ``mean_ap.py:579``)."""
        a = list(_AREA_RANGES).index(area_range)
        m = self.max_detection_thresholds.index(max_dets)
        prec = precision[..., a, m] if avg_prec else recall[..., a, m]
        if iou_threshold is not None:
            prec = prec[self.iou_thresholds.index(iou_threshold)]
        valid = prec[prec > -1]
        return float(valid.mean()) if valid.size else -1.0

    def _summary_values(self, precision: np.ndarray, recall: np.ndarray) -> Dict[str, float]:
        last = self.max_detection_thresholds[-1]
        out: Dict[str, float] = {"map": self._summarize(precision, recall, True, max_dets=last)}
        for key, thr in (("map_50", 0.5), ("map_75", 0.75)):
            out[key] = (self._summarize(precision, recall, True, iou_threshold=thr, max_dets=last)
                        if thr in self.iou_thresholds else -1.0)
        for area in ("small", "medium", "large"):
            out[f"map_{area}"] = self._summarize(precision, recall, True, area_range=area, max_dets=last)
        for max_det in self.max_detection_thresholds:
            out[f"mar_{max_det}"] = self._summarize(precision, recall, False, max_dets=max_det)
        for area in ("small", "medium", "large"):
            out[f"mar_{area}"] = self._summarize(precision, recall, False, area_range=area, max_dets=last)
        return out

    def _summarize_results(self, precision: np.ndarray, recall: np.ndarray) -> Dict[str, Tensor]:
        """The summary numbers as float32 scalars on the metric's device (one copy for all of them)."""
        values = self._summary_values(precision, recall)
        packed = torch.from_numpy(np.asarray(list(values.values()), np.float32)).to(self.device)
        return dict(zip(values, packed.unbind(0)))

    def compute(self) -> Dict[str, Any]:  # noqa: D102 - a dict of values, each squeezed
        with self.sync_context(dist_sync_fn=self.dist_sync_fn, should_sync=self._to_sync):
            return {k: v if isinstance(v, dict) else self._squeeze_if_scalar(v) for k, v in self._compute({}).items()}
