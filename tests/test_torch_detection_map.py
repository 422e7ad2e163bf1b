"""The port's ``MeanAveragePrecision`` (``detection/mean_ap.py``) against the JAX package's, and its greedy
matcher against a plain one.

The same seeded numpy detections go through both packages under ``bbox``, ``segm`` and both, with
``class_metrics``, ``average="micro"``, crowds and annotated areas, empty images, ``extended_summary``,
``max_detection_thresholds`` and every box format: every result JAX's bits (the port keeps JAX's float32
formulas and numpy accumulation). The matcher step by step (ties at IoU 0 included) equals
``chip_smoke.greedy_match_np``, a plain per-group matcher written from the COCO protocol; on the emulated
graph tier (``dispatch.EMULATE_ON_CPU``) it goes in blocks of groups, one capture per block shape, then
replays for any number of groups, with the eager tier's bits. ``chip_smoke.py``'s path T runs here at a small size. The ``cuda`` tests hold the matcher's graph
to its eager run, its device memory flat over evaluations of different sizes, and the mask product to exact
counts on the card:

    python -m pytest --noconftest tests/test_torch_detection_map.py -m cuda
"""
from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

import torchmetrics_tpu_torch.detection as pd  # noqa: E402
from torchmetrics_tpu_torch.detection import mean_ap  # noqa: E402
from torchmetrics_tpu_torch.ops import dispatch  # noqa: E402


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import torchmetrics_tpu.detection as jd

    return SimpleNamespace(jnp=jnp, classes=jd)


def _boxes(rng, n, size=300.0, fmt="xyxy"):
    xy = rng.rand(n, 2) * size
    wh = np.exp(rng.uniform(np.log(4), np.log(size / 2), (n, 2)))
    if fmt == "xywh":
        return np.concatenate([xy, wh], 1).astype(np.float32)
    if fmt == "cxcywh":
        return np.concatenate([xy + wh / 2, wh], 1).astype(np.float32)
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _blob(h, w, box):
    yy, xx = np.mgrid[:h, :w]
    x0, y0, x1, y1 = box
    return (xx >= x0) & (xx < x1) & (yy >= y0) & (yy < y1) & (((xx - (x0 + x1) / 2) + (yy - (y0 + y1) / 2)) % 7 != 0)


def _data(seed, n_img=5, n_cls=3, masks=False, crowd=False, area=False, fmt="xyxy", empty=True):
    """Images of ground truths and jittered detections (half of them kept, tied scores included), with one
    image without detections and one without ground truths."""
    rng = np.random.RandomState(seed)
    preds, target = [], []
    for i in range(n_img):
        n_g = 0 if empty and i == 3 else rng.randint(1, 6)
        gt = _boxes(rng, n_g, fmt=fmt)
        labels = rng.randint(0, n_cls, n_g)
        keep = rng.rand(n_g) < 0.7
        det = np.concatenate([gt[keep] + rng.randn(keep.sum(), 4).astype(np.float32) * 4, _boxes(rng, 3, fmt=fmt)])
        det_labels = np.concatenate([labels[keep], rng.randint(0, n_cls, 3)])
        if empty and i == 1:
            det, det_labels = det[:0], det_labels[:0]
        scores = np.round(rng.rand(det.shape[0]), 1).astype(np.float32)  # ties among the scores
        p = {"boxes": det.astype(np.float32), "scores": scores, "labels": det_labels}
        t = {"boxes": gt, "labels": labels}
        if masks:  # blobs in the (xyxy) boxes scaled to images of two sizes
            h = 40 + 8 * (i % 2)
            p["masks"] = np.stack([_blob(h, 48, b / 8) for b in det]) if det.shape[0] else np.zeros((0, h, 48), bool)
            t["masks"] = np.stack([_blob(h, 48, b / 8) for b in gt]) if n_g else np.zeros((0, h, 48), bool)
        if crowd:
            t["iscrowd"] = (rng.rand(n_g) < 0.3).astype(np.int64)
        if area:
            t["area"] = np.where(rng.rand(n_g) < 0.5, rng.rand(n_g) * 20000, 0).astype(np.float32)
        preds.append(p)
        target.append(t)
    return preds, target


def _jx(jax, items):
    return [{k: jax.jnp.asarray(v) for k, v in d.items()} for d in items]


def _tt(items):
    return [{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()} for d in items]


def _same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        if isinstance(want[key], dict):
            assert sorted(got[key]) == sorted(want[key]), key
            for k in want[key]:
                np.testing.assert_array_equal(got[key][k].numpy(), np.asarray(want[key][k]), err_msg=f"{key} {k}")
        else:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


MAP_CASES = [
    ("bbox", {}, {}),
    ("bbox class_metrics crowds", {"class_metrics": True}, {"crowd": True}),
    ("bbox micro class_metrics", {"average": "micro", "class_metrics": True}, {"crowd": True, "area": True}),
    ("bbox extended_summary", {"extended_summary": True}, {}),
    ("bbox max_detection_thresholds", {"max_detection_thresholds": [1, 2, 4]}, {}),
    ("bbox xywh", {"box_format": "xywh"}, {"fmt": "xywh"}),
    ("bbox cxcywh, thresholds", {"box_format": "cxcywh", "iou_thresholds": [0.3, 0.5, 0.75],
                                 "rec_thresholds": [0.0, 0.5, 1.0]}, {"fmt": "cxcywh"}),
    ("segm", {"iou_type": "segm", "class_metrics": True}, {"masks": True, "crowd": True}),
    ("bbox and segm", {"iou_type": ("bbox", "segm"), "extended_summary": True}, {"masks": True, "area": True}),
    ("no empty images", {"class_metrics": True}, {"empty": False, "n_cls": 1}),
]


@pytest.mark.parametrize("case, kwargs, data", MAP_CASES, ids=[c[0] for c in MAP_CASES])
def test_mean_ap_matches_jax(jax, case, kwargs, data):
    ours, theirs = pd.MeanAveragePrecision(device="cpu", **kwargs), jax.classes.MeanAveragePrecision(**kwargs)
    for step in range(2):
        preds, target = _data(10 * step + len(case), **data)
        ours.update(_tt(preds), _tt(target))
        theirs.update(_jx(jax, preds), _jx(jax, target))
    _same(ours.compute(), theirs.compute())


def test_mask_product_in_slices_matches_jax(jax, monkeypatch):
    """The mask product's pixels in slices (``MASK_SLICE``), whose partial counts are summed: JAX's bits."""
    monkeypatch.setattr(mean_ap, "MASK_SLICE", 100)
    ours = pd.MeanAveragePrecision(iou_type="segm", device="cpu")
    theirs = jax.classes.MeanAveragePrecision(iou_type="segm")
    preds, target = _data(4, masks=True, crowd=True)
    ours.update(_tt(preds), _tt(target))
    theirs.update(_jx(jax, preds), _jx(jax, target))
    _same(ours.compute(), theirs.compute())


def test_mean_ap_before_any_update_and_without_boxes(jax):
    ours, theirs = pd.MeanAveragePrecision(device="cpu"), jax.classes.MeanAveragePrecision()
    _same(ours.compute(), theirs.compute())  # as JAX's, its compute does not warn before an update
    empty = [{"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32), "labels": np.zeros(0, np.int64)}]
    ours.update(_tt(empty), _tt([{"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, np.int64)}]))
    theirs.update(_jx(jax, empty), _jx(jax, [{"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, np.int64)}]))
    _same(ours.compute(), theirs.compute())


@pytest.mark.parametrize("case", ["scores missing", "lengths differ", "iou_type", "iscrowd length", "area length",
                                  "box_format", "average", "backend", "masks missing"])
def test_mean_ap_errors_match_jax(jax, case):
    preds, target = _data(0, n_img=2, empty=False)
    kwargs = {}
    if case == "scores missing":
        del preds[0]["scores"]
    elif case == "lengths differ":
        target = target[:1]
    elif case == "iscrowd length":
        target[0]["iscrowd"] = np.zeros(len(target[0]["labels"]) + 1, np.int64)
    elif case == "area length":
        target[0]["area"] = np.zeros(len(target[0]["labels"]) + 2, np.float32)
    elif case == "masks missing":
        kwargs = {"iou_type": "segm"}
    else:
        kwargs = {{"iou_type": "iou_type", "box_format": "box_format", "average": "average",
                   "backend": "backend"}[case]: "bogus"}
    with pytest.raises(Exception) as theirs:
        jax.classes.MeanAveragePrecision(**kwargs).update(_jx(jax, preds), _jx(jax, target))
    with pytest.raises(theirs.type) as ours:
        pd.MeanAveragePrecision(device="cpu", **kwargs).update(_tt(preds), _tt(target))
    assert str(ours.value) == str(theirs.value)


def _matcher_inputs(seed, p=7, d=6, g=5, a=4, ties=True):
    rng = np.random.RandomState(seed)
    ious = rng.choice([0.0, 0.3, 0.55, 0.55, 0.8, 0.95], (p, d, g)).astype(np.float32) if ties else \
        rng.rand(p, d, g).astype(np.float32)
    det_valid = rng.rand(p, d) < 0.8
    gt_valid = rng.rand(p, g) < 0.8
    gt_ignore = rng.rand(p, a, g) < 0.2
    ious = np.where(det_valid[:, :, None] & gt_valid[:, None, :], ious, 0).astype(np.float32)
    return ious, det_valid, gt_valid, gt_ignore


@pytest.mark.parametrize("ties", [True, False], ids=["tied IoUs", "distinct IoUs"])
def test_matcher_equals_the_plain_greedy_matcher(ties):
    thresholds = np.asarray([0.0, 0.3, 0.5, 0.55, 0.75], np.float32)
    for seed in range(4):
        ious, det_valid, gt_valid, gt_ignore = _matcher_inputs(seed, ties=ties)
        got = mean_ap._match_all_groups(*(torch.from_numpy(x) for x in (ious, det_valid, gt_valid, gt_ignore)),
                                        torch.from_numpy(thresholds)).numpy()
        for j in range(ious.shape[0]):
            nd, ng = int(det_valid[j].sum()), int(gt_valid[j].sum())
            valid_d, valid_g = np.flatnonzero(det_valid[j]), np.flatnonzero(gt_valid[j])
            want = chip_smoke.greedy_match_np(ious[j][np.ix_(valid_d, valid_g)], ~gt_ignore[j][:, valid_g], thresholds)
            np.testing.assert_array_equal(got[j][:, :, valid_d], want)
            assert not got[j][:, :, ~det_valid[j]].any() and nd >= 0 and ng >= 0


def test_matcher_graph_is_one_capture_per_shape_with_the_eager_bits(monkeypatch):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    monkeypatch.setattr(mean_ap, "_MATCH_GRAPHS", {})
    thresholds = torch.linspace(0.5, 0.95, 10)
    dispatch.STATS.reset()
    results = []
    for seed in (0, 1, 2):
        args = tuple(torch.from_numpy(x) for x in _matcher_inputs(seed, p=9 if seed == 2 else 7))
        results.append((mean_ap.match_all_groups(*args, thresholds), mean_ap._match_all_groups(*args, thresholds)))
    assert dispatch.STATS.captures == 2 and dispatch.STATS.replays == 3
    (key, _), = mean_ap._MATCH_GRAPHS.values()  # the device keeps its last graph only: P = 9's block of 16
    assert key[0][0][0] == (16, 6, 5)
    for graph, eager in results:
        assert torch.equal(graph, eager)


@pytest.mark.parametrize("groups", [(9, 13, 7, 4), (1, 5, 16)], ids=["ragged", "whole blocks"])
def test_matcher_graph_replays_its_block_for_any_number_of_groups(monkeypatch, groups):
    """With blocks of 4 groups, computes of 9, 13, 7 and 4 groups (or 1, 5 and 16) replay the one graph
    block by block (a group count below the block takes a block of its own power of two), the last block
    padded with empty groups, with the step-by-step bits."""
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    monkeypatch.setattr(mean_ap, "_MATCH_GRAPHS", {})
    thresholds = torch.linspace(0.5, 0.95, 10)
    monkeypatch.setattr(mean_ap, "MATCH_BLOCK_ELEMS", 4 * 4 * 10 * 5 + 7)  # 4 rows of (A, T, G) = (4, 10, 5)
    dispatch.STATS.reset()
    rows = []
    for seed, p in enumerate(groups):
        args = tuple(torch.from_numpy(x) for x in _matcher_inputs(seed, p=p))
        assert torch.equal(mean_ap.match_all_groups(*args, thresholds), mean_ap._match_all_groups(*args, thresholds))
        rows.append(min(4, mean_ap._next_pow2(p)))
    shapes = [r for i, r in enumerate(rows) if i == 0 or rows[i - 1] != r]
    assert dispatch.STATS.captures == len(shapes)
    assert dispatch.STATS.replays == sum(-(-p // r) for p, r in zip(groups, rows))
    assert len(mean_ap._MATCH_GRAPHS) == 1


def test_run_path_t_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    monkeypatch.setattr(mean_ap, "_MATCH_GRAPHS", {})
    small = dict(chip_smoke.T_SIZES, t1_images=24, t1_boxes=150, t1_dets=20, batch=8, hw=(40, 48), t2_images=6,
                 t3_images=16, t3_batch=8, t3_plain=8, t3_functional=8, workers=0)
    seconds = chip_smoke.run_path_t(torch.device("cpu"), "cpu", small)
    out = capsys.readouterr().out
    assert seconds > 0 and "match tables equal to the plain greedy matcher's" in out and "both tiers bit-equal" in out


def test_mean_ap_oracle_against_jax():
    """``chip_smoke.coco_eval_np`` (the card run's plain evaluation) gives the JAX package's summary."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import torchmetrics_tpu.detection as jd

    small = dict(chip_smoke.T_SIZES, t1_images=12, t1_boxes=60, t1_dets=15)
    d = chip_smoke.path_t1_data(small)
    theirs = jd.MeanAveragePrecision()
    theirs.update([{"boxes": jnp.asarray(b), "scores": jnp.asarray(s), "labels": jnp.asarray(l)}
                   for b, s, l in zip(d["det_boxes"], d["det_scores"], d["det_labels"])],
                  [{"boxes": jnp.asarray(b), "labels": jnp.asarray(l), "iscrowd": jnp.asarray(c)}
                   for b, l, c in zip(d["gt_boxes"], d["gt_labels"], d["gt_crowd"])])
    want = theirs.compute()
    _, summary = chip_smoke.coco_eval_np({"boxes": d["det_boxes"], "scores": d["det_scores"], "labels": d["det_labels"]},
                                         {"boxes": d["gt_boxes"], "labels": d["gt_labels"], "crowd": d["gt_crowd"]},
                                         "boxes", np.linspace(0.5, 0.95, 10).round(2))
    for key in chip_smoke.T_MAP_KEYS:
        np.testing.assert_allclose(summary[key], float(want[key]), atol=1e-6, err_msg=key)


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_matcher_graph_is_the_eager_bits_on_the_card(cuda_device, monkeypatch):
    monkeypatch.setattr(mean_ap, "_MATCH_GRAPHS", {})
    thresholds = torch.linspace(0.5, 0.95, 10, device=cuda_device)
    args = tuple(torch.from_numpy(x).to(cuda_device) for x in _matcher_inputs(3, p=2000, d=64, g=16, ties=True))
    dispatch.STATS.reset()
    graph = [mean_ap.match_all_groups(*args, thresholds) for _ in range(2)]
    assert dispatch.STATS.captures == 1 and dispatch.STATS.replays == 2
    monkeypatch.setenv("TM_TPU_FAST_DISPATCH", "0")
    eager = mean_ap.match_all_groups(*args, thresholds)
    assert torch.equal(graph[0], eager) and torch.equal(graph[1], eager)
    cpu = mean_ap._match_all_groups(*(a.cpu() for a in args), thresholds.cpu())
    assert torch.equal(eager.cpu(), cpu)


@pytest.mark.cuda
def test_matcher_graph_memory_stays_flat_over_group_counts_on_the_card(cuda_device, monkeypatch):
    """20,000, 45,000 and 30,000 groups at the default block (16,384 rows at G = 16): one capture, every
    block a replay, the step-by-step bits, and the device memory after each call the same."""
    monkeypatch.setattr(mean_ap, "_MATCH_GRAPHS", {})
    thresholds = torch.linspace(0.5, 0.95, 10, device=cuda_device)
    dispatch.STATS.reset()
    after = []
    for seed, p in enumerate((20_000, 45_000, 30_000)):
        args = tuple(torch.from_numpy(x).to(cuda_device) for x in _matcher_inputs(seed, p=p, d=64, g=16))
        graph = mean_ap.match_all_groups(*args, thresholds)
        with monkeypatch.context() as env:
            env.setenv("TM_TPU_FAST_DISPATCH", "0")
            assert torch.equal(graph, mean_ap.match_all_groups(*args, thresholds))
        del args, graph
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated())
    assert dispatch.STATS.captures == 1 and dispatch.STATS.replays == 2 + 3 + 2
    assert after[1] == after[0] and after[2] == after[0], after


@pytest.mark.cuda
def test_mean_ap_computes_keep_one_matcher_graph_on_the_card(cuda_device, monkeypatch):
    """Three evaluations with 250, 400 and 550 (image, class) groups, each group 4 detections and 2 ground
    truths, and blocks of 128 groups: one capture in all, the device memory after each evaluation the same,
    and each evaluation the eager tier's values."""
    monkeypatch.setattr(mean_ap, "_MATCH_GRAPHS", {})
    monkeypatch.setattr(mean_ap, "MATCH_BLOCK_ELEMS", 128 * 4 * 10 * 2)
    dispatch.STATS.reset()

    def evaluation(n_img, seed):
        rng = np.random.RandomState(seed)
        preds, target = [], []
        for _ in range(n_img):
            gt = np.repeat(rng.uniform(0, 300, (5, 1, 2)), 2, axis=1).reshape(5, 4)
            gt[:, 2:] += rng.uniform(20, 120, (5, 2))
            gt = np.concatenate([gt, gt + rng.uniform(-5, 5, (5, 4))])
            labels = np.tile(np.arange(5), 2)
            det = np.concatenate([gt, gt + rng.uniform(-15, 15, (10, 4))])
            preds.append({"boxes": torch.tensor(det, dtype=torch.float32, device=cuda_device),
                          "scores": torch.tensor(rng.rand(20), dtype=torch.float32, device=cuda_device),
                          "labels": torch.tensor(np.tile(labels, 2), device=cuda_device)})
            target.append({"boxes": torch.tensor(gt, dtype=torch.float32, device=cuda_device),
                           "labels": torch.tensor(labels, device=cuda_device)})
        out = {}
        for tier in ("1", "0"):
            monkeypatch.setenv("TM_TPU_FAST_DISPATCH", tier)
            m = pd.MeanAveragePrecision(device=cuda_device)
            m.update(preds, target)
            out[tier] = {k: v.cpu() for k, v in m.compute().items() if isinstance(v, torch.Tensor)}
            del m
        for key, value in out["1"].items():
            assert torch.equal(value, out["0"][key]), key
        del preds, target
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    after = [evaluation(n, seed) for seed, n in enumerate((50, 80, 110))]
    assert dispatch.STATS.captures == 1, dispatch.STATS.captures
    assert after[1] == after[0] and after[2] == after[0], after


@pytest.mark.cuda
def test_mask_product_is_exact_on_the_card(cuda_device):
    """0/1 masks at COCO's 480 x 640: the intersections and areas are the whole-number counts, whatever TF32
    flags the caller set, and the IoU is the CPU's bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    det = torch.rand((3, 16, 480 * 640), device=cuda_device, generator=gen) < 0.6
    gt = torch.rand((3, 8, 480 * 640), device=cuda_device, generator=gen) < 0.4
    flags = torch.backends.cuda.matmul.fp32_precision
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    try:
        iou, iod = mean_ap._mask_iou_matrix(det, gt)
    finally:
        torch.backends.cuda.matmul.fp32_precision = flags
    inter = torch.stack([(det[p, :, None, :] & gt[p, None, :, :]).sum(-1) for p in range(3)])  # whole numbers
    union = det.sum(-1)[:, :, None] + gt.sum(-1)[:, None, :] - inter
    assert torch.equal(iou, inter.float() / union.float().clamp(min=1))
    cpu_iou, cpu_iod = mean_ap._mask_iou_matrix(det.cpu(), gt.cpu())
    assert torch.equal(iou.cpu(), cpu_iou) and torch.equal(iod.cpu(), cpu_iod)
