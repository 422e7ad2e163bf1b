"""The fixed-point metrics of the PyTorch port (recall at fixed precision, precision at fixed recall,
specificity at sensitivity), functional and module, against the JAX package on the same numpy
inputs, in the three state regimes of the curve classes: exact, binned and ``approx="sketch"``.

Values and thresholds must agree within atol 1e-6 (float32 curves; exact mode's come from the
same float64 host computation). The row selections are held to JAX's directly on constructed ties
in ``(primary, secondary)``, where the threshold picked shows the row, and on the sentinel
threshold 1e6 of an infeasible floor and of a best value of 0. On the card: one K3 launch per
binned update and one K2 ``sketch_update`` per sketch update, with a compute group.
The JAX side runs op by op (``tests/torch_jax_pool.jax_op_by_op``): each case is a configuration of its own,
which a jitted call would compile whole.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.functional as tf
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.functional.classification.recall_fixed_precision import _lex_select_at_constraint
from torchmetrics_tpu_torch.functional.classification.specificity_sensitivity import _specificity_at_sensitivity
from torchmetrics_tpu_torch.interop import load_numpy_state
from torch_jax_pool import jax_op_by_op  # noqa: F401  (autouse: the JAX side op by op)
#: a case that keeps JAX's jit on (``jax_op_by_op``), so the port is held to JAX's traced branches too
JAX_JITTED_CASES = ('test_functional_matches_jax[recall_at_fixed_precision-binary--1-11]',)

ATOL = 1e-6
METRICS = {  # functional stem: (module stem, floor)
    "recall_at_fixed_precision": ("RecallAtFixedPrecision", 0.6),
    "precision_at_fixed_recall": ("PrecisionAtFixedRecall", 0.5),
    "specificity_at_sensitivity": ("SpecificityAtSensitivity", 0.7),
}


@pytest.fixture(scope="module")
def jax():
    """The JAX package's side, imported here so that the card tests run without JAX:

        python -m pytest --noconftest tests/test_torch_fixed_point.py -m cuda
    """
    pytest.importorskip("jax")
    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu.functional as jf
    from torchmetrics_tpu import MetricCollection as JaxCollection
    from torchmetrics_tpu.functional.classification.recall_fixed_precision import (
        _lex_select_at_constraint as lex_select,
    )
    from torchmetrics_tpu.functional.classification.specificity_sensitivity import (
        _specificity_at_sensitivity as spec_at_sens,
    )

    return SimpleNamespace(functional=jf, classification=jc, MetricCollection=JaxCollection, lex_select=lex_select,
                           spec_at_sens=spec_at_sens)


def assert_close(ours, theirs) -> None:
    """A (value, threshold) pair, or one tensor (AUROC), against the JAX package's arrays."""
    if not isinstance(ours, tuple):
        ours, theirs = (ours,), (theirs,)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=ATOL)


def _batches(task: str, seed: int, ignore_index=None, n: int = 80, n_batches: int = 3, classes: int = 3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        if task == "binary":
            preds = rng.rand(n).astype(np.float32)
            target = (rng.rand(n) < np.clip(preds * 0.8 + 0.1, 0, 1)).astype(np.int64)
        elif task == "multiclass":
            logits = rng.randn(n, classes).astype(np.float32)
            preds = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
            target = rng.randint(0, classes, n)
        else:
            preds = rng.rand(n, classes).astype(np.float32)
            target = (rng.rand(n, classes) < preds).astype(np.int64)
        if ignore_index is not None:
            target[rng.rand(*target.shape) < 0.1] = ignore_index
        out.append((preds, target))
    return out


def _functional(module, metric: str, task: str, preds, target, floor: float, **kwargs):
    fn = getattr(module, f"{task}_{metric}")
    if task == "binary":
        return fn(preds, target, floor, **kwargs)
    return fn(preds, target, 3, floor, **kwargs)  # three classes or labels


@pytest.mark.parametrize("thresholds", [None, 11, [0.1, 0.35, 0.5, 0.8]])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("metric", list(METRICS))
def test_functional_matches_jax(jax, metric, task, ignore_index, thresholds):
    floor = METRICS[metric][1]
    preds, target = _batches(task, seed=len(metric) + len(task), ignore_index=ignore_index, n_batches=1)[0]
    kwargs = dict(thresholds=thresholds, ignore_index=ignore_index)
    ours = _functional(tf, metric, task, torch.from_numpy(preds), torch.from_numpy(target), floor, **kwargs)
    assert_close(ours, _functional(jax.functional, metric, task, preds, target, floor, **kwargs))


@pytest.mark.parametrize("floor", [0.0, 0.45, 0.999, 1.0])
@pytest.mark.parametrize("metric", list(METRICS))
def test_floors_at_the_edges_match_jax(jax, metric, floor):
    """Floor 0 admits every row; 0.999 and 1.0 admit few or none, which gives the 1e6 sentinel."""
    preds, target = _batches("binary", seed=7, n_batches=1, n=40)[0]
    for thresholds in (None, 9):
        ours = _functional(tf, metric, "binary", torch.from_numpy(preds), torch.from_numpy(target), floor,
                           thresholds=thresholds)
        assert_close(ours, _functional(jax.functional, metric, "binary", preds, target, floor, thresholds=thresholds))


def _tied_keys(seed: int, shape=(6, 40)):
    """Keys from a few levels, so that many rows tie in (primary, secondary); distinct thresholds, so
    that the threshold picked names the row."""
    rng = np.random.RandomState(seed)
    levels = np.array([0.0, 0.25, 0.5, 0.75, 1.0], np.float32)
    primary = levels[rng.randint(0, 5, shape)]
    secondary = levels[rng.randint(0, 5, shape)]
    thresholds = np.stack([rng.permutation(shape[1]) for _ in range(shape[0])]).astype(np.float32) / shape[1]
    return primary, secondary, thresholds


@pytest.mark.parametrize("floor", [0.0, 0.3, 0.8, 1.0, 1.5])
@pytest.mark.parametrize("seed", range(4))
def test_lex_select_picks_the_jax_row_on_ties(jax, seed, floor):
    primary, secondary, thresholds = _tied_keys(seed)
    ours = _lex_select_at_constraint(*map(torch.from_numpy, (primary, secondary, thresholds, secondary)), floor)
    theirs = jax.lex_select(primary, secondary, thresholds, secondary, floor)
    assert_close(ours, theirs)


def test_lex_select_tie_rule_and_sentinels():
    primary = torch.tensor([[0.5, 0.5, 0.5, 0.2], [0.0, 0.0, 0.0, 0.0], [0.9, 0.9, 0.9, 0.9]])
    secondary = torch.tensor([[0.7, 0.9, 0.9, 1.0], [0.9, 0.9, 0.9, 0.9], [0.1, 0.1, 0.1, 0.1]])
    thresholds = torch.tensor([[0.1, 0.2, 0.3, 0.4], [0.1, 0.2, 0.3, 0.4], [0.1, 0.2, 0.3, 0.4]])
    best, thr = _lex_select_at_constraint(primary, secondary, thresholds, secondary, 0.5)
    # row 0: the largest primary 0.5 ties thrice, the secondary 0.9 twice, the larger threshold wins;
    # row 1: feasible, but the best value is 0; row 2: no row meets the floor
    assert best.tolist() == pytest.approx([0.5, 0.0, 0.0])
    assert thr.tolist() == pytest.approx([0.3, 1e6, 1e6])


@pytest.mark.parametrize("seed", range(4))
def test_specificity_takes_the_first_maximum_like_jax(jax, seed):
    spec, sens, thresholds = _tied_keys(seed + 10)
    for floor in (0.0, 0.5, 1.0, 1.5):
        ours = _specificity_at_sensitivity(*map(torch.from_numpy, (spec, sens, thresholds)), floor)
        assert_close(ours, jax.spec_at_sens(spec, sens, thresholds, floor))
    ties = torch.tensor([0.3, 0.8, 0.8, 0.8])
    best, thr = _specificity_at_sensitivity(ties, torch.ones(4), torch.tensor([0.9, 0.7, 0.5, 0.3]), 0.5)
    assert float(best) == pytest.approx(0.8) and float(thr) == pytest.approx(0.7)


def _module_case(task: str, regime: str):
    kwargs = {"binned": {"thresholds": 15}, "exact": {}, "sketch": {"approx": "sketch", "sketch_bins": 33},
              "list": {"thresholds": [0.2, 0.4, 0.6, 0.8]}}[regime]
    if task == "multiclass":
        kwargs["num_classes"] = 3
    elif task == "multilabel":
        kwargs["num_labels"] = 3
    return kwargs


CASES = [(metric, task, regime) for metric in METRICS for task in ("binary", "multiclass", "multilabel")
         for regime in ("exact", "binned", "sketch")] + [("recall_at_fixed_precision", "binary", "list")]


def _pair(jax, metric: str, task: str, regime: str, ignore_index=None):
    stem, floor = METRICS[metric]
    name = f"{task.capitalize()}{stem}"
    kwargs = _module_case(task, regime)
    if ignore_index is not None:
        kwargs["ignore_index"] = ignore_index
    key = {"recall_at_fixed_precision": "min_precision", "precision_at_fixed_recall": "min_recall",
           "specificity_at_sensitivity": "min_sensitivity"}[metric]
    kwargs[key] = floor
    return getattr(tc, name)(device="cpu", **kwargs), getattr(jax.classification, name)(**kwargs)


@pytest.mark.parametrize("metric,task,regime", CASES)
def test_module_forward_and_compute_match_jax(jax, metric, task, regime):
    port, jax_metric = _pair(jax, metric, task, regime, ignore_index=-1 if task != "multilabel" else None)
    for preds, target in _batches(task, seed=len(regime) * 7 + len(task), ignore_index=port.ignore_index):
        assert_close(port(preds, target), jax_metric(preds, target))
    assert_close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("regime", ["binned", "sketch", "exact"])
def test_state_carried_from_jax(jax, regime):
    port, jax_metric = _pair(jax, "precision_at_fixed_recall", "multiclass", regime)
    batches = _batches("multiclass", seed=21)
    for preds, target in batches[:2]:
        jax_metric.update(preds, target)
    arrays = {k: [np.asarray(e) for e in v] if isinstance(v, list) else np.asarray(v)
              for k, v in jax_metric.metric_state.items()}
    load_numpy_state(port, arrays)
    port.update(*batches[2])
    jax_metric.update(*batches[2])
    assert_close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("wrapper,kwargs,cls", [
    ("RecallAtFixedPrecision", {"task": "binary", "min_precision": 0.5, "thresholds": 5}, "BinaryRecallAtFixedPrecision"),
    ("RecallAtFixedPrecision", {"task": "multilabel", "num_labels": 2, "min_precision": 0.5},
     "MultilabelRecallAtFixedPrecision"),
    ("PrecisionAtFixedRecall", {"task": "multiclass", "num_classes": 3, "min_recall": 0.4, "approx": "sketch"},
     "MulticlassPrecisionAtFixedRecall"),
    ("SpecificityAtSensitivity", {"task": "binary", "min_sensitivity": 0.3, "ignore_index": -1},
     "BinarySpecificityAtSensitivity"),
    ("SpecificityAtSensitivity", {"task": "multiclass", "num_classes": 3, "min_sensitivity": 0.3, "thresholds": 7},
     "MulticlassSpecificityAtSensitivity"),
])
def test_task_wrappers_build_the_task_class(jax, wrapper, kwargs, cls):
    ours, theirs = getattr(tc, wrapper)(device="cpu", **kwargs), getattr(jax.classification, wrapper)(**kwargs)
    assert type(ours).__name__ == type(theirs).__name__ == cls
    for attr in ("min_precision", "min_recall", "min_sensitivity", "ignore_index", "approx"):
        if hasattr(theirs, attr):
            assert getattr(ours, attr) == getattr(theirs, attr), attr


@pytest.mark.parametrize("build", [
    lambda m: m.BinaryRecallAtFixedPrecision(min_precision=1.5),
    lambda m: m.MulticlassPrecisionAtFixedRecall(num_classes=3, min_recall=1),
    lambda m: m.BinarySpecificityAtSensitivity(min_sensitivity=-0.1),
    lambda m: m.SpecificityAtSensitivity(task="multiclass", min_sensitivity=0.5),
])
def test_arguments_raise_like_jax(jax, build):
    with pytest.raises(ValueError):
        build(jax.classification)
    with pytest.raises(ValueError):
        build(SimpleNamespace(**{n: _cpu(getattr(tc, n)) for n in tc.__all__}))


def _cpu(cls):
    return lambda *args, **kwargs: cls(*args, device="cpu", **kwargs)


def _path_f_members(pkg, **device):
    return [pkg.BinaryRecallAtFixedPrecision(0.5, thresholds=200, **device),
            pkg.BinaryPrecisionAtFixedRecall(0.5, thresholds=200, **device),
            pkg.BinarySpecificityAtSensitivity(0.5, thresholds=200, **device),
            pkg.BinaryAUROC(thresholds=200, **device)]


def test_fixed_point_collection_is_one_compute_group(jax):
    port = MetricCollection(_path_f_members(tc, device="cpu"))
    theirs = jax.MetricCollection(_path_f_members(jax.classification))
    for preds, target in _batches("binary", seed=31, n_batches=4):
        ours, want = port(preds, target), theirs(preds, target)
        for key in want:
            assert_close(ours[key], want[key])
    assert port.compute_groups == theirs.compute_groups
    assert len(port.compute_groups) == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the curve states launch K3 and K2 there")
    return torch.device("cuda", 0)


def _same(got, want) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=ATOL)


@pytest.mark.cuda
def test_binned_collection_launches_k3_once_per_step(cuda_device):
    from torchmetrics_tpu_torch.ops import curve_counts as k3
    from torchmetrics_tpu_torch.ops import dispatch

    on_card, on_cpu = MetricCollection(_path_f_members(tc, device=cuda_device)), MetricCollection(_path_f_members(tc, device="cpu"))
    k3.BINNED_CONFMAT.launches = 0
    dispatch.STATS.reset()
    for step, (preds, target) in enumerate(_batches("binary", seed=31, n_batches=5, n=2000)):
        got, want = on_card(preds, target), on_cpu(preds, target)
        for key in want:
            _same(got[key], want[key])
        # the first step runs per metric; beyond one launch per step, only the graph captures' warm-ups
        assert k3.BINNED_CONFMAT.launches == (4 if step == 0 else 4 + step) + dispatch.STATS.warmup_launches
    for key, value in on_card.compute().items():
        _same(value, on_cpu.compute()[key])


@pytest.mark.cuda
@pytest.mark.parametrize("metric", list(METRICS))
def test_sketch_launches_one_sketch_update_per_update(cuda_device, metric):
    from torchmetrics_tpu_torch.ops import hist_pair as k2

    stem, floor = METRICS[metric]
    cls = getattr(tc, f"Multiclass{stem}")
    on_card = cls(3, floor, approx="sketch", sketch_bins=64, device=cuda_device)
    on_cpu = cls(3, floor, approx="sketch", sketch_bins=64, device="cpu")
    k2.SKETCH_UPDATE.launches = 0
    batches = _batches("multiclass", seed=41, n=2000)
    for preds, target in batches:
        on_card.update(preds, target)
        on_cpu.update(preds, target)
    assert k2.SKETCH_UPDATE.launches == len(batches)
    _same(on_card.compute(), on_cpu.compute())
