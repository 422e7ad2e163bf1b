"""Binary and multilabel stat scores of the PyTorch port (functional and module), the task entries and
wrappers of the whole stat-scores family, against the JAX package on the same numpy inputs.

Counts must be equal exactly (the port's are int64, the JAX package's float32 or int32). Ratios
(accuracy, precision, recall, F-beta) must agree within rtol=1e-6, atol=1e-7: both packages divide
float32 counts, and the averages may sum in another order. Also here: compute groups, states
carried from JAX with ``interop.load_numpy_state``, and, on the card, one K1 launch per step.
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
from torchmetrics_tpu_torch.interop import load_numpy_state
from torch_jax_pool import jax_op_by_op  # noqa: F401  (autouse: the JAX side op by op)
#: a case that keeps JAX's jit on (``jax_op_by_op``), so the port is held to JAX's traced branches too
JAX_JITTED_CASES = ('test_binary_functional_matches_jax[0.5-global--1-probs]',)

RTOL, ATOL = 1e-6, 1e-7
NUM_LABELS = 4
RATIOS = ("accuracy", "precision", "recall", "f1_score")


@pytest.fixture(scope="module")
def jax():
    """The JAX package's side, imported here so that the card tests at the end run without JAX:

        python -m pytest --noconftest tests/test_torch_stat_scores_tasks.py -m cuda
    """
    pytest.importorskip("jax")
    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu.functional as jf
    from torchmetrics_tpu import MetricCollection as JaxCollection

    return SimpleNamespace(functional=jf, classification=jc, MetricCollection=JaxCollection)


def _preds(rng, kind: str, shape):
    if kind == "probs":
        return rng.rand(*shape).astype(np.float32)
    if kind == "logits":
        return (rng.randn(*shape) * 3).astype(np.float32)
    return rng.randint(0, 2, shape)


def _binary_inputs(kind: str, multidim_average: str, ignore_index, seed: int, n: int = 64):
    rng = np.random.RandomState(seed)
    shape = (n,) if multidim_average == "global" else (n, 5)
    target = rng.randint(0, 2, shape)
    if ignore_index is not None:
        target[rng.rand(*shape) < 0.15] = ignore_index
    return _preds(rng, kind, shape), target


def _multilabel_inputs(kind: str, multidim_average: str, ignore_index, seed: int, n: int = 48):
    rng = np.random.RandomState(seed)
    shape = (n, NUM_LABELS) if multidim_average == "global" else (n, NUM_LABELS, 3)
    target = rng.randint(0, 2, shape)
    if ignore_index is not None:
        target[rng.rand(*shape) < 0.15] = ignore_index
    return _preds(rng, kind, shape), target


def _equal(ours: torch.Tensor, theirs) -> None:
    assert ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def _close(ours, theirs) -> None:
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("kind", ["probs", "logits", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1, 0])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_binary_functional_matches_jax(jax, kind, ignore_index, multidim_average, threshold):
    seed = ("probs", "logits", "labels").index(kind) * 10 + (ignore_index or 0) + 3
    preds, target = _binary_inputs(kind, multidim_average, ignore_index, seed)
    kwargs = dict(threshold=threshold, multidim_average=multidim_average, ignore_index=ignore_index)
    _equal(tf.binary_stat_scores(*_t(preds, target), **kwargs), jax.functional.binary_stat_scores(preds, target, **kwargs))
    cm_kwargs = dict(threshold=threshold, ignore_index=ignore_index)
    _equal(tf.binary_confusion_matrix(*_t(preds, target), **cm_kwargs),
           jax.functional.binary_confusion_matrix(preds, target, **cm_kwargs))
    for name in RATIOS:
        fn = f"binary_{name}"
        _close(getattr(tf, fn)(*_t(preds, target), **kwargs), getattr(jax.functional, fn)(preds, target, **kwargs))
    _close(tf.binary_fbeta_score(*_t(preds, target), beta=2.0, **kwargs),
           jax.functional.binary_fbeta_score(preds, target, beta=2.0, **kwargs))


@pytest.mark.parametrize("kind", ["probs", "logits", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
def test_multilabel_functional_matches_jax(jax, kind, ignore_index, average, multidim_average):
    preds, target = _multilabel_inputs(kind, multidim_average, ignore_index, seed=len(kind) + (ignore_index or 0) + 11)
    kwargs = dict(num_labels=NUM_LABELS, average=average, multidim_average=multidim_average,
                  ignore_index=ignore_index, threshold=0.4)
    _equal(tf.multilabel_stat_scores(*_t(preds, target), **kwargs),
           jax.functional.multilabel_stat_scores(preds, target, **kwargs))
    for name in RATIOS:
        fn = f"multilabel_{name}"
        _close(getattr(tf, fn)(*_t(preds, target), **kwargs), getattr(jax.functional, fn)(preds, target, **kwargs))
    _close(tf.multilabel_fbeta_score(*_t(preds, target), beta=0.5, **kwargs),
           jax.functional.multilabel_fbeta_score(preds, target, beta=0.5, **kwargs))


@pytest.mark.parametrize("entry", ["stat_scores", "accuracy", "precision", "recall", "f1_score", "fbeta_score"])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_task_entries_match_jax(jax, entry, task):
    rng = np.random.RandomState(5)
    if task == "multiclass":
        preds, target = rng.randn(60, 5).astype(np.float32), rng.randint(0, 5, 60)
    elif task == "multilabel":
        preds, target = rng.rand(60, NUM_LABELS).astype(np.float32), rng.randint(0, 2, (60, NUM_LABELS))
    else:
        preds, target = rng.rand(60).astype(np.float32), rng.randint(0, 2, 60)
    kwargs = dict(task=task, num_classes=5, num_labels=NUM_LABELS, average="macro", threshold=0.6, ignore_index=-1)
    if entry == "fbeta_score":
        kwargs["beta"] = 2.0
    ours = getattr(tf, entry)(*_t(preds, target), **kwargs)
    theirs = getattr(jax.functional, entry)(preds, target, **kwargs)
    (_equal if entry == "stat_scores" else _close)(ours, theirs)


@pytest.mark.parametrize("entry", ["stat_scores", "accuracy", "f1_score"])
def test_task_entries_check_their_counts(jax, entry):
    checks = [({"task": "multiclass"}, "num_classes"), ({"task": "multilabel"}, "num_labels"),
              ({"task": "regression"}, "Invalid Classification task")]
    if entry == "accuracy":  # the JAX package checks `top_k` in this entry only; the port in every one
        checks.append(({"task": "multiclass", "num_classes": 3, "top_k": None}, "top_k"))
    for kwargs, message in checks:
        for fn in (getattr(tf, entry), getattr(jax.functional, entry)):
                with pytest.raises(ValueError, match=message):
                    fn(np.zeros(4, np.float32), np.zeros(4, np.int64), **kwargs)


@pytest.mark.parametrize("call,error", [
    (lambda f: f.binary_stat_scores(np.array([0.2, 0.8], np.float32), np.array([0, 2])), RuntimeError),
    (lambda f: f.binary_stat_scores(np.array([0, 2]), np.array([0, 1])), RuntimeError),
    (lambda f: f.binary_stat_scores(np.array([0.2, 0.8], np.float32), np.array([0, 1]), threshold=2.0), ValueError),
    (lambda f: f.binary_stat_scores(np.array([0.2], np.float32), np.array([0]), multidim_average="samplewise"), ValueError),
    (lambda f: f.binary_stat_scores(np.zeros(3, np.float32), np.zeros(4, np.int64)), RuntimeError),
    (lambda f: f.multilabel_stat_scores(np.zeros((2, 3), np.float32), np.full((2, 3), 2), 3), RuntimeError),
    (lambda f: f.multilabel_stat_scores(np.zeros((2, 3), np.float32), np.zeros((2, 3), np.int64), 4), ValueError),
    (lambda f: f.multilabel_stat_scores(np.zeros((2, 3), np.float32), np.zeros((2, 3), np.int64), 3,
                                        multidim_average="samplewise"), ValueError),
    (lambda f: f.multilabel_stat_scores(np.zeros((2, 3), np.float32), np.zeros((2, 3), np.int64), 1), ValueError),
    (lambda f: f.binary_fbeta_score(np.zeros(3, np.float32), np.zeros(3, np.int64), beta=0.0), ValueError),
])
def test_invalid_inputs_raise_like_jax(jax, call, error):
    with pytest.raises(error):
        call(jax.functional)
    with pytest.raises(error):
        call(tf)


def test_binary_target_error_lists_the_values(jax):
    preds, target = np.array([0.2, 0.8, 0.4], np.float32), np.array([0, 3, 1])
    with pytest.raises(RuntimeError) as ours:
        tf.binary_accuracy(*_t(preds, target))
    with pytest.raises(RuntimeError) as theirs:
        jax.functional.binary_accuracy(preds, target)
    assert str(ours.value) == str(theirs.value)


def test_samplewise_fused_index_above_shared_bins(jax):
    """``4 * N * L`` = 64,000 bins, more than K1's shared branch holds (58,111): on the card the
    count takes the global branch; here the plain version, against JAX."""
    rng = np.random.RandomState(9)
    preds, target = rng.rand(1600, 10, 2).astype(np.float32), rng.randint(0, 2, (1600, 10, 2))
    target[rng.rand(*target.shape) < 0.1] = -1
    kwargs = dict(num_labels=10, average=None, multidim_average="samplewise", ignore_index=-1)
    _equal(tf.multilabel_stat_scores(*_t(preds, target), **kwargs),
           jax.functional.multilabel_stat_scores(preds, target, **kwargs))


MODULE_CASES = {
    "binary-acc": ("BinaryAccuracy", {}, "binary"),
    "binary-prec-ignore": ("BinaryPrecision", {"ignore_index": -1, "threshold": 0.3}, "binary"),
    "binary-rec-samplewise": ("BinaryRecall", {"multidim_average": "samplewise"}, "binary-2d"),
    "binary-f1": ("BinaryF1Score", {}, "binary"),
    "binary-fbeta-samplewise": ("BinaryFBetaScore", {"beta": 2.0, "multidim_average": "samplewise",
                                                     "ignore_index": -1}, "binary-2d"),
    "binary-stat-scores": ("BinaryStatScores", {"ignore_index": 0}, "binary"),
    "ml-acc-micro": ("MultilabelAccuracy", {"num_labels": NUM_LABELS, "average": "micro"}, "multilabel"),
    "ml-prec-weighted": ("MultilabelPrecision", {"num_labels": NUM_LABELS, "average": "weighted"}, "multilabel"),
    "ml-rec-none-ignore": ("MultilabelRecall", {"num_labels": NUM_LABELS, "average": "none", "ignore_index": -1},
                           "multilabel"),
    "ml-f1-samplewise": ("MultilabelF1Score", {"num_labels": NUM_LABELS, "multidim_average": "samplewise"},
                         "multilabel-3d"),
    "ml-fbeta": ("MultilabelFBetaScore", {"beta": 0.5, "num_labels": NUM_LABELS}, "multilabel"),
    "ml-stat-scores-samplewise": ("MultilabelStatScores", {"num_labels": NUM_LABELS, "average": None,
                                                           "multidim_average": "samplewise"}, "multilabel-3d"),
}


def _module_batches(shape_kind: str, seed: int, ignore_index=None, n_batches: int = 3):
    rng = np.random.RandomState(seed)
    shape = {"binary": (40,), "binary-2d": (40, 3), "multilabel": (40, NUM_LABELS),
             "multilabel-3d": (40, NUM_LABELS, 3)}[shape_kind]
    out = []
    for _ in range(n_batches):
        target = rng.randint(0, 2, shape)
        if ignore_index is not None:
            target[rng.rand(*shape) < 0.1] = ignore_index
        out.append(((rng.randn(*shape) * 2).astype(np.float32), target))
    return out


def _pair(jax, case: str):
    name, kwargs, shape_kind = MODULE_CASES[case]
    batches = _module_batches(shape_kind, seed=len(case), ignore_index=kwargs.get("ignore_index"))
    return getattr(tc, name)(device="cpu", **kwargs), getattr(jax.classification, name)(**kwargs), batches


def _states_equal(port, jax_metric) -> None:
    ours, theirs = port.metric_state, jax_metric.metric_state
    assert sorted(ours) == sorted(theirs)
    for key, value in ours.items():
        if isinstance(value, list):
            assert len(value) == len(theirs[key])
            for a, b in zip(value, theirs[key]):
                _equal(a, b)
        else:
            _equal(value, theirs[key])


def _value(ours, theirs) -> None:
    if ours.dtype == torch.int64:
        _equal(ours, theirs)
    else:
        _close(ours, theirs)


@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_module_forward_and_compute_match_jax(jax, case):
    port, jax_metric, batches = _pair(jax, case)
    for preds, target in batches:
        _value(port(preds, target), jax_metric(preds, target))
    _states_equal(port, jax_metric)
    _value(port.compute(), jax_metric.compute())
    port.reset()
    jax_metric.reset()
    _states_equal(port, jax_metric)


@pytest.mark.parametrize("case", ["binary-prec-ignore", "binary-rec-samplewise", "ml-prec-weighted",
                                  "ml-stat-scores-samplewise"])
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
    _states_equal(port, jax_metric)
    _value(port.compute(), jax_metric.compute())


def test_carried_counts_must_be_whole():
    port = tc.BinaryAccuracy(device="cpu")
    with pytest.raises(ValueError, match="not whole"):
        load_numpy_state(port, {"tp": np.float32(2.5)})


@pytest.mark.parametrize("wrapper,kwargs,cls", [
    ("StatScores", {"task": "binary", "threshold": 0.3}, "BinaryStatScores"),
    ("StatScores", {"task": "multilabel", "num_labels": 3}, "MultilabelStatScores"),
    ("Accuracy", {"task": "binary"}, "BinaryAccuracy"),
    ("Accuracy", {"task": "multiclass", "num_classes": 3, "top_k": 2}, "MulticlassAccuracy"),
    ("Accuracy", {"task": "multilabel", "num_labels": 3, "average": "macro"}, "MultilabelAccuracy"),
    ("Precision", {"task": "binary", "multidim_average": "samplewise"}, "BinaryPrecision"),
    ("Precision", {"task": "multilabel", "num_labels": 3}, "MultilabelPrecision"),
    ("Recall", {"task": "multiclass", "num_classes": 4, "ignore_index": -1}, "MulticlassRecall"),
    ("Recall", {"task": "binary"}, "BinaryRecall"),
    ("FBetaScore", {"task": "binary", "beta": 2.0}, "BinaryFBetaScore"),
    ("FBetaScore", {"task": "multilabel", "num_labels": 3, "beta": 0.5}, "MultilabelFBetaScore"),
    ("F1Score", {"task": "multiclass", "num_classes": 3}, "MulticlassF1Score"),
    ("F1Score", {"task": "multilabel", "num_labels": 3, "threshold": 0.7}, "MultilabelF1Score"),
])
def test_task_wrappers_build_the_task_class(jax, wrapper, kwargs, cls):
    ours, theirs = getattr(tc, wrapper)(device="cpu", **kwargs), getattr(jax.classification, wrapper)(**kwargs)
    assert type(ours).__name__ == type(theirs).__name__ == cls
    for attr in ("threshold", "average", "top_k", "multidim_average", "ignore_index", "beta", "num_labels"):
        if hasattr(theirs, attr):
            assert getattr(ours, attr) == getattr(theirs, attr), attr


def test_task_wrapper_errors():
    with pytest.raises(ValueError, match="num_labels"):
        tc.F1Score(task="multilabel", device="cpu")
    with pytest.raises(ValueError, match="top_k"):
        tc.Accuracy(task="multiclass", num_classes=3, top_k=None, device="cpu")
    with pytest.raises(ValueError, match="Invalid Classification task"):
        tc.Precision(task="ranking", device="cpu")


def _binary_members(pkg, **device):
    return [pkg.BinaryAccuracy(**device), pkg.BinaryPrecision(**device), pkg.BinaryRecall(**device),
            pkg.BinaryF1Score(**device)]


def test_binary_collection_is_one_compute_group(jax):
    port = MetricCollection(_binary_members(tc, device="cpu"))
    theirs = jax.MetricCollection(_binary_members(jax.classification))
    for preds, target in _module_batches("binary", seed=2, n_batches=4):
        ours, want = port(preds, target), theirs(preds, target)
        assert sorted(ours) == sorted(want)
        for key in ours:
            _close(ours[key], want[key])
    assert port.compute_groups == theirs.compute_groups
    assert list(port.compute_groups.values()) == [["BinaryAccuracy", "BinaryPrecision", "BinaryRecall", "BinaryF1Score"]]
    for key, value in port.compute().items():
        _close(value, theirs.compute()[key])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stat scores launch K1 there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_binary_collection_launches_k1_once_per_step(cuda_device):
    from torchmetrics_tpu_torch.ops import bincount as k1
    from torchmetrics_tpu_torch.ops import dispatch

    on_card = MetricCollection(_binary_members(tc, device=cuda_device))
    on_cpu = MetricCollection(_binary_members(tc, device="cpu"))
    batches = _module_batches("binary", seed=2, n_batches=6)
    k1.BINCOUNT.launches = 0
    dispatch.STATS.reset()
    for step, (preds, target) in enumerate(batches):
        got, want = on_card(preds, target), on_cpu(preds, target)
        for key in want:
            torch.testing.assert_close(got[key].cpu(), want[key], rtol=0, atol=1e-7)
        # the first step runs per metric; beyond one launch per step, only the graph captures' warm-ups
        assert k1.BINCOUNT.launches == (4 if step == 0 else 4 + step) + dispatch.STATS.warmup_launches
    for key, value in on_card.compute().items():
        torch.testing.assert_close(value.cpu(), on_cpu.compute()[key], rtol=0, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("multidim_average,rows", [("global", 10), ("samplewise", 1600)])
def test_multilabel_counts_on_cuda_match_cpu(cuda_device, multidim_average, rows):
    """At ``samplewise`` the fused index spans 64,000 bins, above K1's shared branch."""
    from torchmetrics_tpu_torch.ops import bincount as k1

    rng = np.random.RandomState(4)
    preds, target = rng.rand(rows, 10, 4).astype(np.float32), rng.randint(0, 2, (rows, 10, 4))
    target[rng.rand(*target.shape) < 0.1] = -1
    kwargs = dict(num_labels=10, average=None, multidim_average=multidim_average, ignore_index=-1)
    k1.BINCOUNT.launches = 0
    got = tf.multilabel_stat_scores(*[x.to(cuda_device) for x in _t(preds, target)], **kwargs)
    assert k1.BINCOUNT.launches == 1
    assert torch.equal(got.cpu(), tf.multilabel_stat_scores(*_t(preds, target), **kwargs))
