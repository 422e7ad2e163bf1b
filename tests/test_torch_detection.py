"""The port's IoU family and panoptic quality (``functional/detection/``, ``detection/iou.py``,
``detection/panoptic_qualities.py``) against the JAX package's.

The same seeded numpy boxes and panoptic maps go through both packages: the four IoU functionals over their
options (``iou_threshold``, ``replacement_val``, ``aggregate``, empty boxes), the four classes over every
``box_format`` with ``respect_labels``, ``class_metrics`` and ``iou_threshold``, the box conversions; both
panoptic functionals and classes with ``allow_unknown_preds_category``, the void colour, stuff instance ids,
and every error with JAX's message. Counts exactly, values within 1e-6.
"""
from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.detection as pd
import torchmetrics_tpu_torch.functional.detection as pfd
from torchmetrics_tpu_torch.functional.detection.iou import box_area, box_convert

TOL = 1e-6
FUNCTIONALS = ("intersection_over_union", "generalized_intersection_over_union", "distance_intersection_over_union",
               "complete_intersection_over_union")
CLASSES = ("IntersectionOverUnion", "GeneralizedIntersectionOverUnion", "DistanceIntersectionOverUnion",
           "CompleteIntersectionOverUnion")


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import torchmetrics_tpu.detection as jd
    import torchmetrics_tpu.functional.detection as jfd

    return SimpleNamespace(jnp=jnp, classes=jd, functional=jfd,
                           iou=importlib.import_module("torchmetrics_tpu.functional.detection.iou"))


def _close(got, want, tol=TOL):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key], tol)
        return
    g = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=tol, atol=tol, equal_nan=True)


def _boxes(rng, n, fmt="xyxy", size=100.0):
    xy = rng.rand(n, 2) * size
    wh = rng.rand(n, 2) * size / 3 + 1
    if fmt == "xywh":
        return np.concatenate([xy, wh], 1).astype(np.float32)
    if fmt == "cxcywh":
        return np.concatenate([xy + wh / 2, wh], 1).astype(np.float32)
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("kwargs", [{}, {"aggregate": False}, {"iou_threshold": 0.3}, {"iou_threshold": 0.3, "replacement_val": -1.0},
                                    {"iou_threshold": 0.3, "aggregate": False}],
                         ids=["mean", "matrix", "threshold", "replacement", "threshold matrix"])
@pytest.mark.parametrize("name", FUNCTIONALS)
def test_iou_functionals_match_jax(jax, name, kwargs):
    rng = np.random.RandomState(len(name))
    preds = _boxes(rng, 6)
    target = np.concatenate([preds[:3] + rng.randn(3, 4).astype(np.float32) * 3, _boxes(rng, 4)])
    want = getattr(jax.functional, name)(jax.jnp.asarray(preds), jax.jnp.asarray(target), **kwargs)
    got = getattr(pfd, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    _close(got, want)
    empty = getattr(pfd, name)(torch.zeros((0, 4)), torch.from_numpy(target), **kwargs)
    _close(empty, getattr(jax.functional, name)(jax.jnp.zeros((0, 4)), jax.jnp.asarray(target), **kwargs))


@pytest.mark.parametrize("fmt", ["xyxy", "xywh", "cxcywh"])
def test_box_convert_and_area_match_jax(jax, fmt):
    boxes = _boxes(np.random.RandomState(1), 5, fmt)
    got = box_convert(torch.from_numpy(boxes), fmt)
    want = jax.iou.box_convert(jax.jnp.asarray(boxes), fmt)
    _close(got, want)
    _close(box_area(got), jax.iou.box_area(want))
    for bad_in, bad_out in ((fmt, "xywh"), ("xyz", "xyxy")):
        if bad_in == bad_out:
            continue
        with pytest.raises(ValueError) as theirs:
            jax.iou.box_convert(jax.jnp.asarray(boxes), bad_in, bad_out)
        with pytest.raises(ValueError, match=str(theirs.value)):
            box_convert(torch.from_numpy(boxes), bad_in, bad_out)


def _iou_data(rng, fmt, n_img=4, empty=True):
    """Images of 4 detections and 3 ground truths (few shapes for JAX to compile), one with none of each."""
    preds, target = [], []
    for i in range(n_img):
        n_t = 0 if empty and i == 2 else 3
        n_p = 0 if empty and i == 1 else 4
        preds.append({"boxes": _boxes(rng, n_p, fmt), "scores": rng.rand(n_p).astype(np.float32),
                      "labels": rng.randint(0, 3, n_p)})
        target.append({"boxes": _boxes(rng, n_t, fmt), "labels": rng.randint(0, 3, n_t)})
    return preds, target


def _jx(jax, items):
    return [{k: jax.jnp.asarray(v) for k, v in d.items()} for d in items]


def _tt(items):
    return [{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()} for d in items]


IOU_CASES = [(name, fmt, kwargs) for i, (name, kwargs) in enumerate(
    (n, k) for n in CLASSES for k in ({}, {"respect_labels": False}, {"class_metrics": True}, {"iou_threshold": 0.2},
                                      {"class_metrics": True, "respect_labels": False, "iou_threshold": 0.1}))
    for fmt in (("xyxy", "xywh", "cxcywh")[i % 3],)]


@pytest.mark.parametrize("name, fmt, kwargs", IOU_CASES, ids=[f"{n}-{f}-{sorted(k)}" for n, f, k in IOU_CASES])
def test_iou_classes_match_jax(jax, name, fmt, kwargs):
    rng = np.random.RandomState(len(name) + len(fmt) + len(kwargs))
    ours = getattr(pd, name)(box_format=fmt, device="cpu", **kwargs)
    theirs = getattr(jax.classes, name)(box_format=fmt, **kwargs)
    for _ in range(2):
        preds, target = _iou_data(rng, fmt)
        ours.update(_tt(preds), _tt(target))
        theirs.update(_jx(jax, preds), _jx(jax, target))
    _close(ours.compute(), theirs.compute())


@pytest.mark.parametrize("case, make", [
    ("box_format", lambda ns, **kw: ns.IntersectionOverUnion(box_format="xyzw", **kw)),
    ("class_metrics", lambda ns, **kw: ns.IntersectionOverUnion(class_metrics=1, **kw)),
    ("respect_labels", lambda ns, **kw: ns.IntersectionOverUnion(respect_labels="yes", **kw)),
], ids=lambda x: x if isinstance(x, str) else "")
def test_iou_class_arguments_match_jax(jax, case, make):
    with pytest.raises(ValueError) as theirs:
        make(jax.classes)
    with pytest.raises(ValueError) as ours:
        make(pd, device="cpu")
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("case", ["no labels key", "lengths differ", "not a sequence", "boxes and labels disagree"])
def test_iou_input_errors_match_jax(jax, case):
    box = np.zeros((1, 4), np.float32)
    preds = [{"boxes": box, "labels": np.zeros(1, np.int64)}]
    target = [{"boxes": box, "labels": np.zeros(1, np.int64)}]
    if case == "no labels key":
        target = [{"boxes": box}]
    elif case == "lengths differ":
        target = target * 2
    elif case == "not a sequence":
        preds = {"boxes": box}
    else:
        target = [{"boxes": np.zeros((2, 4), np.float32), "labels": np.zeros(1, np.int64)}]
    conv = (lambda x: x) if case == "not a sequence" else None
    with pytest.raises(ValueError) as theirs:
        jax.classes.IntersectionOverUnion().update(conv(preds) if conv else _jx(jax, preds), _jx(jax, target))
    with pytest.raises(ValueError) as ours:
        pd.IntersectionOverUnion(device="cpu").update(conv(preds) if conv else _tt(preds), _tt(target))
    assert str(ours.value).split(",")[0] == str(theirs.value).split(",")[0]


# ------------------------------------------------------------------ panoptic quality
THINGS, STUFFS = {1, 3, 7}, {2, 5}


def _panoptic(rng, n=3, h=10, w=12, unknown=0.0):
    cats = np.array(sorted(THINGS | STUFFS))
    target = np.stack([rng.choice(cats, (n, h, w)), rng.randint(0, 3, (n, h, w))], -1)
    preds = target.copy()
    flip = rng.rand(n, h, w) < 0.3
    preds[..., 0][flip] = rng.choice(cats, flip.sum())
    preds[..., 1][flip] = rng.randint(0, 4, flip.sum())
    if unknown:
        void = rng.rand(n, h, w) < unknown
        target[..., 0][void] = 9  # not a category: the void colour
        odd = rng.rand(n, h, w) < unknown
        preds[..., 0][odd] = 11
    return preds, target


@pytest.mark.parametrize("allow_unknown", [False, True])
@pytest.mark.parametrize("modified", [False, True])
def test_panoptic_functionals_match_jax(jax, modified, allow_unknown):
    name = "modified_panoptic_quality" if modified else "panoptic_quality"
    for seed in range(3):
        preds, target = _panoptic(np.random.RandomState(seed), unknown=0.1 if allow_unknown else 0.0)
        if not allow_unknown:  # the target's unknown categories are void either way
            target[..., 0][np.random.RandomState(seed + 9).rand(*target.shape[:3]) < 0.1] = 9
        want = getattr(jax.functional, name)(jax.jnp.asarray(preds), jax.jnp.asarray(target), THINGS, STUFFS,
                                             allow_unknown_preds_category=allow_unknown)
        got = getattr(pfd, name)(torch.from_numpy(preds), torch.from_numpy(target), THINGS, STUFFS,
                                 allow_unknown_preds_category=allow_unknown)
        _close(got, want)


@pytest.mark.parametrize("cls", ["PanopticQuality", "ModifiedPanopticQuality"])
def test_panoptic_classes_match_jax(jax, cls):
    """``forward``'s batch values, the sums (counts exactly), the compute, and large instance ids (COCO's
    RGB-encoded ones)."""
    ours = getattr(pd, cls)(THINGS, STUFFS, allow_unknown_preds_category=True, device="cpu")
    theirs = getattr(jax.classes, cls)(THINGS, STUFFS, allow_unknown_preds_category=True)
    rng = np.random.RandomState(4)
    for step in range(3):
        preds, target = _panoptic(rng, unknown=0.05)
        if step == 2:
            preds[..., 1] *= 1 << 20
            target[..., 1] *= 1 << 20
        _close(ours(torch.from_numpy(preds), torch.from_numpy(target)), theirs(jax.jnp.asarray(preds), jax.jnp.asarray(target)))
    for key, value in theirs.metric_state.items():
        _close(ours.metric_state[key], np.asarray(value))
    assert ours.metric_state["true_positives"].dtype == torch.int64
    _close(ours.compute(), theirs.compute())


PANOPTIC_ERRORS = [
    ("things and stuffs overlap", lambda ns, **kw: ns.PanopticQuality({1, 2}, {2, 3}, **kw)),
    ("no categories", lambda ns, **kw: ns.PanopticQuality(set(), set(), **kw)),
]


@pytest.mark.parametrize("case, make", PANOPTIC_ERRORS, ids=[c[0] for c in PANOPTIC_ERRORS])
def test_panoptic_arguments_match_jax(jax, case, make):
    with pytest.raises(ValueError) as theirs:
        make(jax.classes)
    with pytest.raises(ValueError) as ours:
        make(pd, device="cpu")
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("case", ["shapes differ", "no spatial dimension", "three channels", "unknown category"])
def test_panoptic_input_errors_match_jax(jax, case):
    preds, target = _panoptic(np.random.RandomState(0))
    if case == "shapes differ":
        target = target[:, :5]
    elif case == "no spatial dimension":
        preds, target = preds[:, 0, 0], target[:, 0, 0]
    elif case == "three channels":
        preds, target = (np.concatenate([x, x[..., :1]], -1) for x in (preds, target))
    else:
        preds[0, 0, 0, 0] = 11
    with pytest.raises(ValueError) as theirs:
        jax.functional.panoptic_quality(jax.jnp.asarray(preds), jax.jnp.asarray(target), THINGS, STUFFS)
    with pytest.raises(ValueError) as ours:
        pfd.panoptic_quality(torch.from_numpy(preds), torch.from_numpy(target), THINGS, STUFFS)
    assert str(ours.value) == str(theirs.value)


def test_detection_metrics_default_to_cuda(monkeypatch):
    from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    preds, target = _panoptic(np.random.RandomState(0))
    for make in [lambda **kw: getattr(pd, name)(**kw) for name in CLASSES + ("MeanAveragePrecision",)] + [
            lambda **kw: pd.PanopticQuality(THINGS, STUFFS, **kw),
            lambda **kw: pfd.panoptic_quality(preds, target, THINGS, STUFFS, **kw)]:
        with pytest.raises(TorchMetricsUserError, match="device='cpu'"):
            make()
        assert make(device="cpu").device == torch.device("cpu")


def test_panoptic_pair_tables_in_chunks_match_jax(jax, monkeypatch):
    """The pair areas taken a few images at a time (``PAIR_CHUNK_PIXELS``) give JAX's sums: the IoU sums add
    in float64 in image order across the chunks."""
    panoptic = importlib.import_module("torchmetrics_tpu_torch.functional.detection.panoptic")
    monkeypatch.setattr(panoptic, "PAIR_CHUNK_PIXELS", 2 * 10 * 12)
    preds, target = _panoptic(np.random.RandomState(8), n=7, unknown=0.05)
    for name in ("panoptic_quality", "modified_panoptic_quality"):
        want = getattr(jax.functional, name)(jax.jnp.asarray(preds), jax.jnp.asarray(target), THINGS, STUFFS,
                                             allow_unknown_preds_category=True)
        got = getattr(pfd, name)(torch.from_numpy(preds), torch.from_numpy(target), THINGS, STUFFS,
                                 allow_unknown_preds_category=True)
        _close(got, want)
