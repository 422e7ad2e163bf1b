"""The curve family's module metrics in the PyTorch port against the JAX package, in all three state
regimes: exact (``cat`` list states), binned (a ``(T, ..., 2, 2)`` confmat) and ``approx="sketch"``
(a histogram pair).

Each metric goes through ``forward`` over several numpy batches and then ``compute`` in both
packages. States must be equal exactly (counts of 0/1 weights, and the formatted scores of exact
mode); batch values and computed values within atol 1e-6 (float32 divisions and sums in another
order). Also here: compute groups in ``MetricCollection``, states carried from JAX with
``interop.load_numpy_state``, the task wrappers and the sketch's state descriptors.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.interop import load_numpy_state
from torchmetrics_tpu_torch.sketch import (
    SketchSpec,
    auroc_error_bound,
    hist_spec,
    score_bucket,
    sketch_descriptor,
    sketch_state_bytes,
)

BATCH, N_BATCHES = 96, 3
ATOL = 1e-6


@pytest.fixture(scope="module")
def jax():
    """The JAX package's side, imported here so that the card test at the end runs without JAX:

        python -m pytest --noconftest tests/test_torch_curve_metrics.py -m cuda
    """
    pytest.importorskip("jax")
    import torchmetrics_tpu.classification as jc
    from torchmetrics_tpu import MetricCollection
    from torchmetrics_tpu.sketch import hist, state

    return SimpleNamespace(classification=jc, MetricCollection=MetricCollection, hist=hist, state=state)


def assert_close(ours, theirs, atol: float = ATOL) -> None:
    """Tensors, or (nested) tuples, lists and dicts of them, against the JAX package's arrays."""
    if isinstance(ours, dict):
        assert sorted(ours) == sorted(theirs)
        for key in ours:
            assert_close(ours[key], theirs[key], atol)
        return
    if isinstance(ours, (tuple, list)):
        assert isinstance(theirs, (tuple, list)) and len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert_close(a, b, atol)
        return
    assert isinstance(ours, torch.Tensor)
    theirs = np.asarray(theirs)
    assert tuple(ours.shape) == theirs.shape
    np.testing.assert_allclose(ours.cpu().numpy(), theirs, rtol=0, atol=atol)


def _binary_batches(seed: int, ignore_index=None):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(N_BATCHES):
        preds = rng.rand(BATCH).astype(np.float32)
        target = (rng.rand(BATCH) < np.clip(preds * 0.8 + 0.1, 0, 1)).astype(np.int64)
        if ignore_index is not None:
            target[rng.rand(BATCH) < 0.1] = ignore_index
        out.append((preds, target))
    return out


def _multiclass_batches(seed: int, num_classes: int = 3, ignore_index=None):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(N_BATCHES):
        logits = rng.randn(BATCH, num_classes).astype(np.float32)
        preds = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
        target = rng.randint(0, num_classes, BATCH)
        if ignore_index is not None:
            target[rng.rand(BATCH) < 0.1] = ignore_index
        out.append((preds, target))
    return out


def _multilabel_batches(seed: int, num_labels: int = 3):
    rng = np.random.RandomState(seed)
    return [(rng.rand(BATCH, num_labels).astype(np.float32), (rng.rand(BATCH, num_labels) < 0.5).astype(np.int64))
            for _ in range(N_BATCHES)]


# (class name, constructor kwargs, batches); the same class exists in both packages
CASES = {
    "binary-prc-exact": ("BinaryPrecisionRecallCurve", {}, _binary_batches(0)),
    "binary-prc-int-ignore": ("BinaryPrecisionRecallCurve", {"thresholds": 25, "ignore_index": -1},
                              _binary_batches(1, ignore_index=-1)),
    "binary-prc-list": ("BinaryPrecisionRecallCurve", {"thresholds": [0.0, 0.3, 0.5, 0.8]}, _binary_batches(2)),
    "binary-prc-array": ("BinaryPrecisionRecallCurve", {"thresholds": np.linspace(0, 1, 9, dtype=np.float32)},
                         _binary_batches(3)),
    "binary-prc-sketch": ("BinaryPrecisionRecallCurve", {"approx": "sketch", "sketch_bins": 64}, _binary_batches(4)),
    "binary-roc-sketch": ("BinaryROC", {"approx": "sketch", "sketch_bins": 33}, _binary_batches(5)),
    "binary-roc-exact": ("BinaryROC", {}, _binary_batches(6)),
    "binary-auroc-maxfpr": ("BinaryAUROC", {"thresholds": 40, "max_fpr": 0.4}, _binary_batches(7)),
    "binary-auroc-exact": ("BinaryAUROC", {}, _binary_batches(8)),
    "binary-auroc-sketch": ("BinaryAUROC", {"approx": "sketch", "sketch_bins": 128}, _binary_batches(9)),
    "binary-ap-exact-ignore": ("BinaryAveragePrecision", {"ignore_index": -1}, _binary_batches(10, ignore_index=-1)),
    "binary-ap-int": ("BinaryAveragePrecision", {"thresholds": 30}, _binary_batches(11)),
    "mc-prc-int": ("MulticlassPrecisionRecallCurve", {"num_classes": 3, "thresholds": 20}, _multiclass_batches(12)),
    "mc-prc-micro-exact": ("MulticlassPrecisionRecallCurve", {"num_classes": 3, "average": "micro"},
                           _multiclass_batches(13)),
    "mc-prc-micro-sketch": ("MulticlassPrecisionRecallCurve", {"num_classes": 3, "average": "micro", "approx": "sketch",
                                                               "sketch_bins": 50}, _multiclass_batches(14)),
    "mc-roc-exact-ignore": ("MulticlassROC", {"num_classes": 3, "ignore_index": 0},
                            _multiclass_batches(15, ignore_index=0)),
    "mc-auroc-macro-int": ("MulticlassAUROC", {"num_classes": 3, "thresholds": 20}, _multiclass_batches(16)),
    "mc-auroc-weighted-exact": ("MulticlassAUROC", {"num_classes": 3, "average": "weighted"}, _multiclass_batches(17)),
    "mc-auroc-none-sketch": ("MulticlassAUROC", {"num_classes": 3, "average": None, "approx": "sketch",
                                                 "sketch_bins": 40}, _multiclass_batches(18)),
    "mc-ap-macro-list": ("MulticlassAveragePrecision", {"num_classes": 3, "thresholds": [0.1, 0.4, 0.6, 0.9]},
                         _multiclass_batches(19)),
    "ml-prc-exact": ("MultilabelPrecisionRecallCurve", {"num_labels": 3}, _multilabel_batches(20)),
    "ml-roc-int": ("MultilabelROC", {"num_labels": 3, "thresholds": 15}, _multilabel_batches(21)),
    "ml-auroc-micro-int": ("MultilabelAUROC", {"num_labels": 3, "average": "micro", "thresholds": 15},
                           _multilabel_batches(22)),
    "ml-auroc-macro-sketch": ("MultilabelAUROC", {"num_labels": 3, "approx": "sketch", "sketch_bins": 40},
                              _multilabel_batches(23)),
    "ml-ap-weighted-exact": ("MultilabelAveragePrecision", {"num_labels": 3, "average": "weighted"},
                             _multilabel_batches(24)),
    "ml-ap-micro-exact": ("MultilabelAveragePrecision", {"num_labels": 3, "average": "micro"}, _multilabel_batches(25)),
}


def _pair(jax, case: str):
    name, kwargs, batches = CASES[case]
    return getattr(tc, name)(device="cpu", **kwargs), getattr(jax.classification, name)(**kwargs), batches


def assert_states_equal(port, jax_metric) -> None:
    ours, theirs = port.metric_state, jax_metric.metric_state
    assert sorted(ours) == sorted(theirs)
    for key, value in ours.items():
        if isinstance(value, list):
            assert len(value) == len(theirs[key])
            for a, b in zip(value, theirs[key]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
        else:
            assert value.dtype == torch.float32
            np.testing.assert_array_equal(value.numpy(), np.asarray(theirs[key]), err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_compute_match_jax(jax, case):
    port, jax_metric, batches = _pair(jax, case)
    for preds, target in batches:
        assert_close(port(preds, target), jax_metric(preds, target))
    assert_states_equal(port, jax_metric)
    assert_close(port.compute(), jax_metric.compute())
    port.reset()
    jax_metric.reset()
    assert_states_equal(port, jax_metric)


@pytest.mark.parametrize("case", ["binary-prc-int-ignore", "binary-auroc-exact", "mc-auroc-none-sketch"])
def test_update_then_compute_matches_jax(jax, case):
    port, jax_metric, batches = _pair(jax, case)
    for preds, target in batches:
        port.update(preds, target)
        jax_metric.update(preds, target)
    assert_states_equal(port, jax_metric)
    assert_close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("case", ["binary-ap-int", "binary-auroc-sketch", "binary-roc-exact", "ml-auroc-micro-int",
                                  "mc-prc-micro-sketch", "ml-ap-weighted-exact"])
def test_state_carried_from_jax(jax, case):
    port, jax_metric, batches = _pair(jax, case)
    for preds, target in batches[:2]:
        jax_metric.update(preds, target)
    arrays = {k: [np.asarray(e) for e in v] if isinstance(v, list) else np.asarray(v)
              for k, v in jax_metric.metric_state.items()}
    load_numpy_state(port, arrays)
    preds, target = batches[2]
    port.update(preds, target)
    jax_metric.update(preds, target)
    assert_states_equal(port, jax_metric)
    assert_close(port.compute(), jax_metric.compute())


def test_compute_groups_match_jax(jax):
    def members(pkg, **device):
        return {
            "auroc": pkg.BinaryAUROC(thresholds=20, **device),
            "ap": pkg.BinaryAveragePrecision(thresholds=20, **device),
            "roc_other_grid": pkg.BinaryROC(thresholds=10, **device),
            "auroc_sketch": pkg.BinaryAUROC(approx="sketch", sketch_bins=20, **device),
            "ap_sketch": pkg.BinaryAveragePrecision(approx="sketch", sketch_bins=20, **device),
            "auroc_exact": pkg.BinaryAUROC(**device),
            "prc_exact": pkg.BinaryPrecisionRecallCurve(**device),
        }

    port, jax_mc = MetricCollection(members(tc, device="cpu")), jax.MetricCollection(members(jax.classification))
    for preds, target in _binary_batches(30):
        assert_close(port(preds, target), jax_mc(preds, target))
    # equal binned states group; a sketch never groups with a binned grid, even an equal one
    assert port.compute_groups == jax_mc.compute_groups
    groups = sorted(sorted(g) for g in port.compute_groups.values())
    assert ["ap", "auroc"] in groups and ["ap_sketch", "auroc_sketch"] in groups
    assert ["auroc_exact", "prc_exact"] in groups
    assert_close(port.compute(), jax_mc.compute())
    for name in port.compute():
        assert_states_equal(port[name], jax_mc[name])


@pytest.mark.parametrize("wrapper,kwargs,cls", [
    ("PrecisionRecallCurve", {"task": "binary", "thresholds": 5}, "BinaryPrecisionRecallCurve"),
    ("ROC", {"task": "multiclass", "num_classes": 3}, "MulticlassROC"),
    ("AUROC", {"task": "binary", "max_fpr": 0.5}, "BinaryAUROC"),
    ("AUROC", {"task": "multiclass", "num_classes": 3, "average": "weighted"}, "MulticlassAUROC"),
    ("AUROC", {"task": "multilabel", "num_labels": 2, "average": "micro"}, "MultilabelAUROC"),
    ("AveragePrecision", {"task": "multilabel", "num_labels": 2, "approx": "sketch"}, "MultilabelAveragePrecision"),
])
def test_task_wrappers_build_the_task_class(jax, wrapper, kwargs, cls):
    ours, theirs = getattr(tc, wrapper)(device="cpu", **kwargs), getattr(jax.classification, wrapper)(**kwargs)
    assert type(ours).__name__ == type(theirs).__name__ == cls
    for attr in ("max_fpr", "_auroc_average", "average", "approx"):
        if hasattr(theirs, attr):
            assert getattr(ours, attr) == getattr(theirs, attr)


def test_task_wrapper_errors():
    with pytest.raises(ValueError, match="num_classes"):
        tc.AUROC(task="multiclass", device="cpu")
    with pytest.raises(ValueError, match="Invalid Classification task"):
        tc.ROC(task="regression", device="cpu")
    wrapper = _ClassificationTaskWrapper(device="cpu")
    with pytest.raises(NotImplementedError, match="wrapper class"):
        wrapper.update(None, None)
    with pytest.raises(NotImplementedError, match="wrapper class"):
        wrapper.compute()


@pytest.mark.parametrize("kwargs,error", [
    ({"approx": "kll"}, ValueError),
    ({"approx": "sketch", "thresholds": 10}, ValueError),
    ({"approx": "sketch", "sketch_bins": 1}, ValueError),
])
def test_curve_arguments_raise_like_jax(jax, kwargs, error):
    with pytest.raises(error):
        jax.classification.BinaryAUROC(**kwargs)
    with pytest.raises(error):
        tc.BinaryAUROC(device="cpu", **kwargs)


def test_sketch_descriptors_match_jax(jax):
    for kwargs in ({"sketch_bins": 64}, {"num_classes": 4, "sketch_bins": 32}):
        name = "MulticlassAUROC" if "num_classes" in kwargs else "BinaryAUROC"
        ours = getattr(tc, name)(approx="sketch", device="cpu", **kwargs)
        theirs = getattr(jax.classification, name)(approx="sketch", **kwargs)
        assert sketch_descriptor(ours) == jax.state.sketch_descriptor(theirs)
        assert sketch_state_bytes(ours) == jax.state.sketch_state_bytes(theirs)
    assert sketch_descriptor(tc.BinaryAUROC(thresholds=5, device="cpu")) is None
    assert hist_spec(100, 3).state_bytes() == jax.state.hist_spec(100, 3).state_bytes()
    assert auroc_error_bound(2048) == jax.hist.auroc_error_bound(2048)
    with pytest.raises(NotImplementedError, match="item 7"):
        SketchSpec(kind="kll")
    with pytest.raises(ValueError, match="unknown sketch kind"):
        SketchSpec(kind="bloom")


@pytest.mark.parametrize("bins", [2, 64, 2048])
def test_score_bucket_matches_jax_on_edges(jax, bins):
    knots = np.arange(bins, dtype=np.float32) / np.float32(bins - 1)
    scores = np.concatenate([
        knots, np.nextafter(knots, np.float32(-1)), np.nextafter(knots, np.float32(2)),
        np.array([np.nan, np.inf, -np.inf, -0.5, 1.5, 0.0, 1.0], np.float32),
        np.random.RandomState(bins).rand(500).astype(np.float32),
    ]).astype(np.float32)
    ours = score_bucket(torch.from_numpy(scores), bins)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax.hist.score_bucket(scores, bins)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the curve metrics launch K2 and K3 there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["binary-prc-int-ignore", "binary-auroc-sketch", "mc-auroc-macro-int",
                                  "mc-auroc-none-sketch", "ml-auroc-macro-sketch", "binary-auroc-exact"])
def test_metrics_on_cuda_match_cpu(cuda_device, case):
    name, kwargs, batches = CASES[case]
    on_card, on_cpu = getattr(tc, name)(device=cuda_device, **kwargs), getattr(tc, name)(device="cpu", **kwargs)
    for preds, target in batches:
        torch.testing.assert_close(on_card(preds, target), on_cpu(preds, target), rtol=0, atol=1e-6, check_device=False)
    for key, value in on_card.metric_state.items():
        want = on_cpu.metric_state[key]
        if isinstance(value, list):
            assert all(torch.equal(a.cpu(), b) for a, b in zip(value, want))
        else:
            assert torch.equal(value.cpu(), want)
    torch.testing.assert_close(on_card.compute(), on_cpu.compute(), rtol=0, atol=1e-6, check_device=False)


@pytest.mark.cuda
def test_to_moves_the_threshold_grid(cuda_device):
    metric = tc.BinaryAUROC(thresholds=50, device="cpu").to(cuda_device)
    assert metric.thresholds.device == metric.metric_state["confmat"].device == cuda_device
    preds, target = CASES["binary-auroc-maxfpr"][2][0]
    value = metric(torch.from_numpy(preds).to(cuda_device), torch.from_numpy(target).to(cuda_device))
    want = tc.BinaryAUROC(thresholds=50, device="cpu")(preds, target)
    torch.testing.assert_close(value.cpu(), want, rtol=0, atol=1e-6)
