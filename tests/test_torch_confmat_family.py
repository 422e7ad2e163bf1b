"""Cohen's kappa, MCC and the Jaccard index of the PyTorch port (functional and module), against the
JAX package on the same seeded numpy inputs.

All three reduce the confusion matrix, counted by K1 on the card (its plain version here): the
confusion-matrix states must be equal exactly; the values within rtol=1e-6, atol=1e-6 (absolute
too, because MCC and kappa of random labels lie near 0, where a relative bound fails). Also here:
every task entry and wrapper, the three as one compute group, the binary MCC edge cases, an
absent class, an all-ignored batch and, on the card, one K1 launch per step for the group.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.functional as tf
from torchmetrics_tpu_torch import MetricCollection

RTOL = ATOL = 1e-6
NUM_CLASSES, NUM_LABELS = 5, 4


@pytest.fixture(scope="module")
def jax():
    """The JAX package's side, imported here so that the card tests run without JAX:

        python -m pytest --noconftest tests/test_torch_confmat_family.py -m cuda
    """
    pytest.importorskip("jax")
    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu.functional as jf
    from torchmetrics_tpu import MetricCollection as JaxCollection

    return SimpleNamespace(functional=jf, classification=jc, MetricCollection=JaxCollection)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(ours, theirs) -> None:
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL)


def _inputs(task: str, kind: str, ignore_index, seed: int, n: int = 60):
    rng = np.random.RandomState(seed)
    if task == "binary":
        target = rng.randint(0, 2, n)
        preds = rng.rand(n).astype(np.float32) if kind == "probs" else (
            (rng.randn(n) * 3).astype(np.float32) if kind == "logits" else rng.randint(0, 2, n))
    elif task == "multiclass":
        target = rng.randint(0, NUM_CLASSES, n)
        preds = rng.randn(n, NUM_CLASSES).astype(np.float32) if kind != "labels" else rng.randint(0, NUM_CLASSES, n)
    else:
        target = rng.randint(0, 2, (n, NUM_LABELS))
        preds = rng.rand(n, NUM_LABELS).astype(np.float32) if kind != "labels" else rng.randint(0, 2, (n, NUM_LABELS))
    if ignore_index is not None:
        target[rng.rand(*target.shape) < 0.15] = ignore_index
    return preds, target


@pytest.mark.parametrize("kind", ["probs", "logits", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1, 0])
@pytest.mark.parametrize("weights", [None, "linear", "quadratic"])
def test_binary_functional_matches_jax(jax, kind, ignore_index, weights):
    preds, target = _inputs("binary", kind, ignore_index, seed=len(kind) + (ignore_index or 0) + 1)
    kw = dict(threshold=0.4, ignore_index=ignore_index)
    _close(tf.binary_cohen_kappa(*_t(preds, target), weights=weights, **kw),
           jax.functional.binary_cohen_kappa(preds, target, weights=weights, **kw))
    _close(tf.binary_matthews_corrcoef(*_t(preds, target), **kw), jax.functional.binary_matthews_corrcoef(preds, target, **kw))
    _close(tf.binary_jaccard_index(*_t(preds, target), **kw), jax.functional.binary_jaccard_index(preds, target, **kw))


@pytest.mark.parametrize("kind", ["scores", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1, 1])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
def test_multiclass_functional_matches_jax(jax, kind, ignore_index, average):
    preds, target = _inputs("multiclass", kind, ignore_index, seed=len(kind) * 3 + (ignore_index or 0) + 2)
    kw = dict(num_classes=NUM_CLASSES, ignore_index=ignore_index)
    _close(tf.multiclass_jaccard_index(*_t(preds, target), average=average, **kw),
           jax.functional.multiclass_jaccard_index(preds, target, average=average, **kw))
    _close(tf.multiclass_matthews_corrcoef(*_t(preds, target), **kw),
           jax.functional.multiclass_matthews_corrcoef(preds, target, **kw))
    for weights in (None, "linear", "quadratic"):
        _close(tf.multiclass_cohen_kappa(*_t(preds, target), weights=weights, **kw),
               jax.functional.multiclass_cohen_kappa(preds, target, weights=weights, **kw))


@pytest.mark.parametrize("kind", ["probs", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
def test_multilabel_functional_matches_jax(jax, kind, ignore_index, average):
    preds, target = _inputs("multilabel", kind, ignore_index, seed=len(kind) + (ignore_index or 0) + 7)
    kw = dict(num_labels=NUM_LABELS, ignore_index=ignore_index, threshold=0.6)
    _close(tf.multilabel_jaccard_index(*_t(preds, target), average=average, **kw),
           jax.functional.multilabel_jaccard_index(preds, target, average=average, **kw))
    _close(tf.multilabel_matthews_corrcoef(*_t(preds, target), **kw),
           jax.functional.multilabel_matthews_corrcoef(preds, target, **kw))


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_task_entries_match_jax(jax, task):
    preds, target = _inputs(task, "labels" if task == "multiclass" else "probs", None, seed=11)
    kw = dict(task=task, num_classes=NUM_CLASSES, num_labels=NUM_LABELS)
    _close(tf.jaccard_index(*_t(preds, target), **kw), jax.functional.jaccard_index(preds, target, **kw))
    _close(tf.matthews_corrcoef(*_t(preds, target), **kw), jax.functional.matthews_corrcoef(preds, target, **kw))
    if task != "multilabel":
        kw.pop("num_labels")
        _close(tf.cohen_kappa(*_t(preds, target), weights="linear", **kw),
               jax.functional.cohen_kappa(preds, target, weights="linear", **kw))


@pytest.mark.parametrize("case", ["all_right", "all_wrong", "all_positive", "all_negative_preds", "one_each"])
def test_binary_mcc_edge_cases_match_jax(jax, case):
    """The fallback with ``sqrt(eps)`` where the denominator is 0, and the +1 / -1 overrides."""
    preds, target = {
        "all_right": ([1, 0, 1, 0], [1, 0, 1, 0]),
        "all_wrong": ([0, 1, 0, 1], [1, 0, 1, 0]),
        "all_positive": ([1, 1, 1, 1], [1, 1, 1, 1]),
        "all_negative_preds": ([0, 0, 0, 0], [1, 0, 1, 0]),
        "one_each": ([1, 0, 0, 0], [0, 0, 0, 0]),
    }[case]
    preds, target = np.asarray(preds), np.asarray(target)
    _close(tf.binary_matthews_corrcoef(*_t(preds, target)), jax.functional.binary_matthews_corrcoef(preds, target))
    for weights in (None, "quadratic"):
        ours = tf.binary_cohen_kappa(*_t(preds, target), weights=weights)
        theirs = np.asarray(jax.functional.binary_cohen_kappa(preds, target, weights=weights))
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=RTOL, atol=ATOL, equal_nan=True)


def test_absent_class_and_all_ignored_match_jax(jax):
    """Class 3 appears in neither target nor preds (weight 0 in the macro Jaccard); then a batch
    whose targets are all ``ignore_index``."""
    rng = np.random.RandomState(4)
    target = rng.choice([0, 1, 2, 4], 50)
    preds = rng.choice([0, 1, 2, 4], 50)
    for average in ("macro", "micro", "weighted", "none"):
        _close(tf.multiclass_jaccard_index(*_t(preds, target), NUM_CLASSES, average=average),
               jax.functional.multiclass_jaccard_index(preds, target, NUM_CLASSES, average=average))
    ignored = np.full(20, -1)
    p20 = rng.randint(0, NUM_CLASSES, 20)
    _close(tf.multiclass_matthews_corrcoef(*_t(p20, ignored), NUM_CLASSES, ignore_index=-1),
           jax.functional.multiclass_matthews_corrcoef(p20, ignored, NUM_CLASSES, ignore_index=-1))
    ours = tf.multiclass_cohen_kappa(*_t(p20, ignored), NUM_CLASSES, ignore_index=-1)
    theirs = jax.functional.multiclass_cohen_kappa(p20, ignored, NUM_CLASSES, ignore_index=-1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), equal_nan=True)


def _members(pkg, **device):
    kw = dict(num_classes=NUM_CLASSES, ignore_index=-1, **device)
    return [pkg.MulticlassCohenKappa(weights="quadratic", **kw), pkg.MulticlassMatthewsCorrCoef(**kw),
            pkg.MulticlassJaccardIndex(**kw)]


def _batches(task: str, n_batches: int, seed: int, ignore_index=-1):
    kind = "scores" if task == "multiclass" else "probs"
    return [_inputs(task, kind, ignore_index, seed=seed + i, n=40) for i in range(n_batches)]


def test_collection_is_one_compute_group_and_matches_jax(jax):
    port = MetricCollection(_members(tc, device="cpu"))
    theirs = jax.MetricCollection(_members(jax.classification))
    for preds, target in _batches("multiclass", 4, seed=20):
        ours, want = port(preds, target), theirs(preds, target)
        for key in want:
            _close(ours[key], want[key])
    assert port.compute_groups == theirs.compute_groups
    assert list(port.compute_groups.values()) == [["MulticlassCohenKappa", "MulticlassMatthewsCorrCoef",
                                                   "MulticlassJaccardIndex"]]
    for key, value in port.compute().items():
        _close(value, theirs.compute()[key])
    for member in port.values():
        np.testing.assert_array_equal(member.metric_state["confmat"].numpy(),
                                      np.asarray(theirs[type(member).__name__].metric_state["confmat"]))


CLASSES = [
    ("BinaryCohenKappa", {"weights": "linear"}, "binary"),
    ("BinaryMatthewsCorrCoef", {"threshold": 0.3}, "binary"),
    ("BinaryJaccardIndex", {"ignore_index": -1}, "binary"),
    ("MulticlassCohenKappa", {"num_classes": NUM_CLASSES}, "multiclass"),
    ("MulticlassMatthewsCorrCoef", {"num_classes": NUM_CLASSES, "ignore_index": -1}, "multiclass"),
    ("MulticlassJaccardIndex", {"num_classes": NUM_CLASSES, "average": "weighted", "ignore_index": -1}, "multiclass"),
    ("MultilabelMatthewsCorrCoef", {"num_labels": NUM_LABELS, "ignore_index": -1}, "multilabel"),
    ("MultilabelJaccardIndex", {"num_labels": NUM_LABELS, "average": "micro"}, "multilabel"),
]


@pytest.mark.parametrize("name,kwargs,task", CLASSES, ids=[c[0] + str(i) for i, c in enumerate(CLASSES)])
def test_class_forward_update_compute_reset_match_jax(jax, name, kwargs, task):
    ours, theirs = getattr(tc, name)(device="cpu", **kwargs), getattr(jax.classification, name)(**kwargs)
    batches = _batches(task, 3, seed=30, ignore_index=kwargs.get("ignore_index"))
    for preds, target in batches[:2]:
        _close(ours(*_t(preds, target)), theirs(preds, target))
    ours.update(*_t(*batches[2]))
    theirs.update(*batches[2])
    _close(ours.compute(), theirs.compute())
    np.testing.assert_array_equal(ours.metric_state["confmat"].numpy(), np.asarray(theirs.metric_state["confmat"]))
    ours.reset()
    theirs.reset()
    ours.update(*_t(*batches[0]))
    theirs.update(*batches[0])
    _close(ours.compute(), theirs.compute())


@pytest.mark.parametrize("wrapper,kwargs,cls", [
    ("CohenKappa", {"task": "binary"}, "BinaryCohenKappa"),
    ("CohenKappa", {"task": "multiclass", "num_classes": 3, "weights": "quadratic"}, "MulticlassCohenKappa"),
    ("MatthewsCorrCoef", {"task": "binary"}, "BinaryMatthewsCorrCoef"),
    ("MatthewsCorrCoef", {"task": "multiclass", "num_classes": 3}, "MulticlassMatthewsCorrCoef"),
    ("MatthewsCorrCoef", {"task": "multilabel", "num_labels": 3}, "MultilabelMatthewsCorrCoef"),
    ("JaccardIndex", {"task": "binary"}, "BinaryJaccardIndex"),
    ("JaccardIndex", {"task": "multiclass", "num_classes": 3, "average": "micro"}, "MulticlassJaccardIndex"),
    ("JaccardIndex", {"task": "multilabel", "num_labels": 3}, "MultilabelJaccardIndex"),
])
def test_task_wrappers_build_the_task_class(jax, wrapper, kwargs, cls):
    ours, theirs = getattr(tc, wrapper)(device="cpu", **kwargs), getattr(jax.classification, wrapper)(**kwargs)
    assert type(ours).__name__ == type(theirs).__name__ == cls
    for attr in ("threshold", "average", "weights", "ignore_index", "num_classes", "num_labels"):
        if hasattr(theirs, attr):
            assert getattr(ours, attr) == getattr(theirs, attr), attr


def test_argument_errors_match_jax(jax):
    for make in (lambda pkg, **d: pkg.MulticlassCohenKappa(3, weights="cubic", **d),
                 lambda pkg, **d: pkg.CohenKappa(task="multilabel", **d),
                 lambda pkg, **d: pkg.JaccardIndex(task="multiclass", **d)):
        with pytest.raises(ValueError) as theirs:
            make(jax.classification)
        with pytest.raises(ValueError, match=str(theirs.value).split(":")[0][:30]):
            make(tc, device="cpu")
    with pytest.raises(ValueError, match="The `average` has to be one of"):
        tf.multiclass_jaccard_index(torch.tensor([0, 1]), torch.tensor([0, 1]), 2, average="samples")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the confusion matrix launches K1 there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_group_launches_k1_once_per_step_on_the_card(cuda_device):
    from torchmetrics_tpu_torch.ops import bincount as k1
    from torchmetrics_tpu_torch.ops import dispatch

    on_card, on_cpu = MetricCollection(_members(tc, device=cuda_device)), MetricCollection(_members(tc, device="cpu"))
    dispatch.STATS.reset()
    k1.BINCOUNT.launches = 0
    for step, (preds, target) in enumerate(_batches("multiclass", 6, seed=40)):
        got, want = on_card(*_t(preds, target)), on_cpu(*_t(preds, target))
        for key in want:
            torch.testing.assert_close(got[key].cpu(), want[key], rtol=0, atol=1e-6)
        assert k1.BINCOUNT.launches == (3 if step == 0 else 3 + step) + dispatch.STATS.warmup_launches
    card_fallbacks = {k: n for k, n in dispatch.STATS.fallbacks.items() if k[2] != "cpu_device"}  # the CPU twin's apart
    assert card_fallbacks == {}
