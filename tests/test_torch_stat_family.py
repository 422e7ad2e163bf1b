"""Specificity, Hamming distance, Dice and exact match of the PyTorch port (functional and module),
against the JAX package on the same seeded numpy inputs.

Specificity and Hamming distance reduce the stat-score counts (K1 on the card, its plain version
here), Dice the multiclass counts, exact match its own compares. Count states must be equal
exactly; values within rtol=1e-6, atol=1e-7, as for the rest of the stat-scores family. Also
here: every ``average``, ``multidim_average``, ``top_k`` and ``ignore_index``, the task entries
and wrappers, compute groups with ``Accuracy``, Dice's ``multiclass=False`` and ``samples``
paths, and the states' dtypes, which stay the JAX package's for Dice and exact match.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.functional as tf
from torchmetrics_tpu_torch import MetricCollection

RTOL, ATOL = 1e-6, 1e-7
NUM_CLASSES, NUM_LABELS = 4, 3


@pytest.fixture(scope="module")
def jax():
    """The JAX package's side, imported here so that the card tests run without JAX:

        python -m pytest --noconftest tests/test_torch_stat_family.py -m cuda
    """
    pytest.importorskip("jax")
    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu.functional as jf
    from torchmetrics_tpu import MetricCollection as JaxCollection

    return SimpleNamespace(functional=jf, classification=jc, MetricCollection=JaxCollection)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(ours, theirs, rtol: float = RTOL) -> None:
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=rtol, atol=ATOL)


def _inputs(task: str, kind: str, multidim_average: str, ignore_index, seed: int, n: int = 48):
    rng = np.random.RandomState(seed)
    extra = () if multidim_average == "global" else (3,)
    if task == "binary":
        shape = (n,) + extra
        target = rng.randint(0, 2, shape)
        preds = rng.rand(*shape).astype(np.float32) if kind == "probs" else rng.randint(0, 2, shape)
    elif task == "multiclass":
        target = rng.randint(0, NUM_CLASSES, (n,) + extra)
        preds = (rng.randn(n, NUM_CLASSES, *extra).astype(np.float32) if kind == "scores"
                 else rng.randint(0, NUM_CLASSES, (n,) + extra))
    else:
        shape = (n, NUM_LABELS) + extra
        target = rng.randint(0, 2, shape)
        preds = (rng.randn(*shape) * 2).astype(np.float32) if kind == "logits" else rng.randint(0, 2, shape)
    if ignore_index is not None:
        target[rng.rand(*target.shape) < 0.15] = ignore_index
    return preds, target


FAMILY = ("specificity", "hamming_distance")


@pytest.mark.parametrize("kind", ["probs", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1, 1])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
def test_binary_functional_matches_jax(jax, kind, ignore_index, multidim_average):
    preds, target = _inputs("binary", kind, multidim_average, ignore_index, seed=len(kind) + (ignore_index or 0) + 1)
    kw = dict(threshold=0.4, multidim_average=multidim_average, ignore_index=ignore_index)
    for name in FAMILY:
        fn = f"binary_{name}"
        _close(getattr(tf, fn)(*_t(preds, target), **kw), getattr(jax.functional, fn)(preds, target, **kw))


@pytest.mark.parametrize("kind,top_k", [("scores", 1), ("scores", 2), ("labels", 1)])  # top_k > 1 needs scores
@pytest.mark.parametrize("ignore_index", [None, -1, 0])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
def test_multiclass_functional_matches_jax(jax, kind, ignore_index, average, multidim_average, top_k):
    preds, target = _inputs("multiclass", kind, multidim_average, ignore_index,
                            seed=len(kind) * 2 + (ignore_index or 0) + top_k + 3)
    kw = dict(num_classes=NUM_CLASSES, average=average, multidim_average=multidim_average,
              ignore_index=ignore_index, top_k=top_k)
    for name in FAMILY:
        fn = f"multiclass_{name}"
        _close(getattr(tf, fn)(*_t(preds, target), **kw), getattr(jax.functional, fn)(preds, target, **kw))
    if top_k == 1 and average == "micro":
        kw = dict(num_classes=NUM_CLASSES, multidim_average=multidim_average, ignore_index=ignore_index)
        _close(tf.multiclass_exact_match(*_t(preds, target), **kw), jax.functional.multiclass_exact_match(preds, target, **kw))


@pytest.mark.parametrize("kind", ["logits", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
def test_multilabel_functional_matches_jax(jax, kind, ignore_index, average, multidim_average):
    preds, target = _inputs("multilabel", kind, multidim_average, ignore_index, seed=len(kind) + (ignore_index or 0) + 9)
    kw = dict(num_labels=NUM_LABELS, average=average, multidim_average=multidim_average, ignore_index=ignore_index,
              threshold=0.6)
    for name in FAMILY:
        fn = f"multilabel_{name}"
        _close(getattr(tf, fn)(*_t(preds, target), **kw), getattr(jax.functional, fn)(preds, target, **kw))
    kw.pop("average")
    _close(tf.multilabel_exact_match(*_t(preds, target), **kw), jax.functional.multilabel_exact_match(preds, target, **kw))


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_task_entries_match_jax(jax, task):
    kind = {"binary": "probs", "multiclass": "scores", "multilabel": "logits"}[task]
    preds, target = _inputs(task, kind, "global", None, seed=13)
    kw = dict(task=task, num_classes=NUM_CLASSES, num_labels=NUM_LABELS)
    _close(tf.specificity(*_t(preds, target), **kw), jax.functional.specificity(preds, target, **kw))
    _close(tf.hamming_distance(*_t(preds, target), **kw), jax.functional.hamming_distance(preds, target, **kw))
    if task != "binary":
        _close(tf.exact_match(*_t(preds, target), **kw), jax.functional.exact_match(preds, target, **kw))


DICE_CASES = [
    ("labels", dict()),
    ("labels", dict(average="macro", num_classes=NUM_CLASSES)),
    ("labels", dict(average="none", num_classes=NUM_CLASSES, ignore_index=1)),
    ("labels", dict(average="samples", num_classes=NUM_CLASSES)),
    ("labels", dict(average="micro", mdmc_average="samplewise", num_classes=NUM_CLASSES)),
    ("scores", dict(average="macro")),
    ("scores", dict(average="micro", top_k=2)),
    ("scores", dict(average="macro", top_k=2, num_classes=NUM_CLASSES, zero_division=1.0)),
    ("binary_probs", dict(threshold=0.3)),
    ("binary_probs", dict(average="macro")),
    ("binary_probs", dict(multiclass=False)),
    ("binary_scores", dict(multiclass=False, average="macro")),
    ("binary_labels", dict(multiclass=False, average="none")),
    ("binary_labels", dict(multiclass=True, average="none")),
]


def _dice_inputs(kind: str, seed: int, n: int = 40, samplewise: bool = False):
    rng = np.random.RandomState(seed)
    extra = (3,) if samplewise else ()
    if kind == "labels":
        return rng.randint(0, NUM_CLASSES, (n,) + extra), rng.randint(0, NUM_CLASSES, (n,) + extra)
    if kind == "scores":
        return rng.rand(n, NUM_CLASSES, *extra).astype(np.float32), rng.randint(0, NUM_CLASSES, (n,) + extra)
    if kind == "binary_probs":
        return rng.rand(n).astype(np.float32), rng.randint(0, 2, n)
    if kind == "binary_scores":
        return rng.rand(n, 2).astype(np.float32), rng.randint(0, 2, n)
    return rng.randint(0, 2, n), rng.randint(0, 2, n)


@pytest.mark.parametrize("kind,kwargs", DICE_CASES, ids=[f"{k}-{i}" for i, (k, _) in enumerate(DICE_CASES)])
def test_dice_functional_matches_jax(jax, kind, kwargs):
    preds, target = _dice_inputs(kind, seed=len(kind) + len(kwargs), samplewise=kwargs.get("mdmc_average") == "samplewise")
    _close(tf.dice(*_t(preds, target), **kwargs), jax.functional.dice(preds, target, **kwargs))


def test_dice_multiclass_false_value_checks_match_jax(jax):
    """The legacy checks, which read the device, raise as the JAX package's functional form does."""
    for preds, target, match in (([0, 2, 1], [0, 1, 1], "`preds` should not exceed 1"),
                                 ([0, 1, 1], [0, 2, 1], "`target` should not exceed 1"),
                                 ([[0.2, 0.5, 0.3]], [1], "more than 2 classes")):
        preds = np.asarray(preds, np.float32 if isinstance(preds[0], list) else np.int64)
        with pytest.raises(ValueError, match=match):
            jax.functional.dice(preds, np.asarray(target), multiclass=False)
        with pytest.raises(ValueError, match=match):
            tf.dice(*_t(preds, np.asarray(target)), multiclass=False)
    with pytest.raises(ValueError, match="can not use `ignore_index` with binary data"):
        tf.dice(*_t([0, 1], [0, 1]), multiclass=False, ignore_index=0)


DICE_CLASSES = [
    ("labels", dict(num_classes=NUM_CLASSES, average="macro")),
    ("labels", dict(num_classes=NUM_CLASSES, average="none", ignore_index=2)),
    ("labels", dict(num_classes=NUM_CLASSES, average="samples")),
    ("scores", dict(num_classes=NUM_CLASSES, average="micro", top_k=2)),
    ("binary_probs", dict()),
    ("binary_labels", dict(multiclass=False, average="macro")),
]


@pytest.mark.parametrize("kind,kwargs", DICE_CLASSES, ids=[f"{k}-{i}" for i, (k, _) in enumerate(DICE_CLASSES)])
def test_dice_class_matches_jax(jax, kind, kwargs):
    ours, theirs = tc.Dice(device="cpu", **kwargs), jax.classification.Dice(**kwargs)
    batches = [_dice_inputs(kind, seed=50 + i) for i in range(3)]
    if "ignore_index" in kwargs:
        # the JAX package's Dice module cannot run with ignore_index (a boolean mask under jit,
        # NonConcreteBooleanIndexError): hold the port's class to JAX's functional dice instead
        for i in range(len(batches)):
            ours.update(*_t(*batches[i]))
            preds, target = (np.concatenate(x) for x in zip(*batches[:i + 1]))
            _close(ours.compute(), jax.functional.dice(preds, target, **kwargs))
        return
    for preds, target in batches[:2]:
        _close(ours(*_t(preds, target)), theirs(preds, target))
    ours.update(*_t(*batches[2]))
    theirs.update(*batches[2])
    _close(ours.compute(), theirs.compute())
    for key, value in theirs.metric_state.items():
        got = ours.metric_state[key]
        if isinstance(value, list):
            assert len(got) == len(value) and all(g.dtype == torch.float32 for g in got)
            np.testing.assert_array_equal(torch.cat(got).numpy(), np.concatenate([np.asarray(v) for v in value]))
        else:
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(value))
    ours.reset()
    assert ours.metric_state["tp"] == [] if kwargs.get("average") == "samples" else not ours.metric_state["tp"].any()


STAT_CLASSES = [
    ("BinarySpecificity", {"threshold": 0.3}, "binary", "probs"),
    ("BinaryHammingDistance", {"multidim_average": "samplewise", "ignore_index": -1}, "binary", "probs"),
    ("MulticlassSpecificity", {"num_classes": NUM_CLASSES, "average": "weighted", "ignore_index": -1}, "multiclass",
     "scores"),
    ("MulticlassHammingDistance", {"num_classes": NUM_CLASSES, "top_k": 2}, "multiclass", "scores"),
    ("MulticlassHammingDistance", {"num_classes": NUM_CLASSES, "multidim_average": "samplewise"}, "multiclass", "labels"),
    ("MultilabelSpecificity", {"num_labels": NUM_LABELS, "average": "micro"}, "multilabel", "logits"),
    ("MultilabelHammingDistance", {"num_labels": NUM_LABELS, "average": "none", "ignore_index": -1}, "multilabel",
     "logits"),
    ("MulticlassExactMatch", {"num_classes": NUM_CLASSES, "multidim_average": "samplewise"}, "multiclass", "labels"),
    ("MulticlassExactMatch", {"num_classes": NUM_CLASSES, "ignore_index": -1, "multidim_average": "samplewise"},
     "multiclass", "labels"),
    ("MultilabelExactMatch", {"num_labels": NUM_LABELS, "ignore_index": -1}, "multilabel", "labels"),
    ("MultilabelExactMatch", {"num_labels": NUM_LABELS, "multidim_average": "samplewise"}, "multilabel", "logits"),
]


@pytest.mark.parametrize("name,kwargs,task,kind", STAT_CLASSES, ids=[f"{c[0]}-{i}" for i, c in enumerate(STAT_CLASSES)])
def test_class_forward_update_compute_reset_match_jax(jax, name, kwargs, task, kind):
    ours, theirs = getattr(tc, name)(device="cpu", **kwargs), getattr(jax.classification, name)(**kwargs)
    mda = kwargs.get("multidim_average", "global")
    if "ExactMatch" in name and task == "multiclass":
        mda = "samplewise"  # exact match over the positions of each sample
    batches = [_inputs(task, kind, mda, kwargs.get("ignore_index"), seed=60 + i) for i in range(3)]
    for preds, target in batches[:2]:
        _close(ours(*_t(preds, target)), theirs(preds, target))
    ours.update(*_t(*batches[2]))
    theirs.update(*batches[2])
    _close(ours.compute(), theirs.compute())
    for key, value in theirs.metric_state.items():
        got = ours.metric_state[key]
        got = torch.cat(got) if isinstance(got, list) else got
        want = np.concatenate([np.asarray(v) for v in value]) if isinstance(value, list) else np.asarray(value)
        np.testing.assert_array_equal(got.numpy(), want)
    ours.reset()
    theirs.reset()
    ours.update(*_t(*batches[1]))
    theirs.update(*batches[1])
    _close(ours.compute(), theirs.compute())


def test_specificity_and_hamming_share_a_group_with_accuracy(jax):
    def members(pkg, **device):
        kw = dict(num_classes=NUM_CLASSES, average="macro", **device)
        return [pkg.MulticlassAccuracy(**kw), pkg.MulticlassSpecificity(**kw), pkg.MulticlassHammingDistance(**kw)]

    port, theirs = MetricCollection(members(tc, device="cpu")), jax.MetricCollection(members(jax.classification))
    for i in range(3):
        preds, target = _inputs("multiclass", "scores", "global", None, seed=70 + i)
        ours, want = port(*_t(preds, target)), theirs(preds, target)
        for key in want:
            _close(ours[key], want[key])
    assert port.compute_groups == theirs.compute_groups
    assert len(port.compute_groups) == 1


@pytest.mark.parametrize("wrapper,kwargs,cls", [
    ("Specificity", {"task": "binary"}, "BinarySpecificity"),
    ("Specificity", {"task": "multiclass", "num_classes": 3, "top_k": 2}, "MulticlassSpecificity"),
    ("Specificity", {"task": "multilabel", "num_labels": 3}, "MultilabelSpecificity"),
    ("HammingDistance", {"task": "binary", "threshold": 0.2}, "BinaryHammingDistance"),
    ("HammingDistance", {"task": "multiclass", "num_classes": 3}, "MulticlassHammingDistance"),
    ("HammingDistance", {"task": "multilabel", "num_labels": 3, "average": "macro"}, "MultilabelHammingDistance"),
    ("ExactMatch", {"task": "multiclass", "num_classes": 3}, "MulticlassExactMatch"),
    ("ExactMatch", {"task": "multilabel", "num_labels": 3, "threshold": 0.7}, "MultilabelExactMatch"),
])
def test_task_wrappers_build_the_task_class(jax, wrapper, kwargs, cls):
    ours, theirs = getattr(tc, wrapper)(device="cpu", **kwargs), getattr(jax.classification, wrapper)(**kwargs)
    assert type(ours).__name__ == type(theirs).__name__ == cls
    for attr in ("threshold", "average", "top_k", "multidim_average", "ignore_index", "num_labels", "num_classes"):
        if hasattr(theirs, attr):
            assert getattr(ours, attr) == getattr(theirs, attr), attr


def test_exact_match_has_no_binary_task(jax):
    with pytest.raises(ValueError, match="Invalid Classification task"):
        jax.classification.ExactMatch(task="binary")
    with pytest.raises(ValueError, match="Invalid Classification task"):
        tc.ExactMatch(task="binary", device="cpu")
    with pytest.raises(ValueError, match="Invalid Classification task"):
        tf.exact_match(*_t([0], [0]), task="binary")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stat scores launch K1 there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,kwargs", DICE_CLASSES, ids=[f"{k}-{i}" for i, (k, _) in enumerate(DICE_CLASSES)])
def test_dice_on_the_card_equals_cpu(cuda_device, kind, kwargs):
    on_card, on_cpu = tc.Dice(device=cuda_device, **kwargs), tc.Dice(device="cpu", **kwargs)
    for i in range(4):
        preds, target = _t(*_dice_inputs(kind, seed=80 + i))
        torch.testing.assert_close(on_card(preds, target).cpu(), on_cpu(preds, target), rtol=0, atol=1e-7)
    torch.testing.assert_close(on_card.compute().cpu(), on_cpu.compute(), rtol=0, atol=1e-7)
