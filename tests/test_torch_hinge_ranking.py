"""Hinge loss and the multilabel ranking metrics of the PyTorch port (functional and module), against
the JAX package on the same seeded numpy inputs.

Values must agree within rtol=1e-5, atol=1e-6, looser than the stat-score families' 1e-6: both
are float32 sums of per-sample losses, and XLA and PyTorch add them in different orders (a
pairwise tree against a vectorised cascade), which moves the last bits of a sum of a few hundred
terms. The ranking metrics' counts (ranks, mis-ordered pairs, coverage) are integers and exact on
both sides. Each ranking metric is also held to sklearn's definition through a per-sample numpy
loop, with tied scores and ignored labels.
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
from torch_jax_pool import jax_op_by_op  # noqa: F401  (autouse: the JAX side op by op)
#: a case that keeps JAX's jit on (``jax_op_by_op``), so the port is held to JAX's traced branches too
JAX_JITTED_CASES = ('test_binary_hinge_matches_jax[False--1-probs]',)

RTOL, ATOL = 1e-5, 1e-6
NUM_CLASSES, NUM_LABELS = 5, 6
RANKING = ("multilabel_coverage_error", "multilabel_ranking_average_precision", "multilabel_ranking_loss")


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu.functional as jf

    return SimpleNamespace(functional=jf, classification=jc)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(ours, theirs) -> None:
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=RTOL, atol=ATOL)


def _binary(kind: str, ignore_index, seed: int, n: int = 64):
    rng = np.random.RandomState(seed)
    preds = rng.rand(n).astype(np.float32) if kind == "probs" else (rng.randn(n) * 3).astype(np.float32)
    target = rng.randint(0, 2, n)
    if ignore_index is not None:
        target[rng.rand(n) < 0.15] = ignore_index
    return preds, target


def _multiclass(kind: str, ignore_index, seed: int, n: int = 64, extra=()):
    rng = np.random.RandomState(seed)
    scores = rng.randn(n, NUM_CLASSES, *extra).astype(np.float32) * 2
    if kind == "probs":
        scores = np.exp(scores) / np.exp(scores).sum(axis=1, keepdims=True)
    target = rng.randint(0, NUM_CLASSES, (n,) + extra)
    if ignore_index is not None:
        target[rng.rand(*target.shape) < 0.15] = ignore_index
    return scores.astype(np.float32), target


@pytest.mark.parametrize("kind", ["probs", "logits"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("squared", [False, True])
def test_binary_hinge_matches_jax(jax, kind, ignore_index, squared):
    preds, target = _binary(kind, ignore_index, seed=len(kind) + int(squared))
    kw = dict(squared=squared, ignore_index=ignore_index)
    _close(tf.binary_hinge_loss(*_t(preds, target), **kw), jax.functional.binary_hinge_loss(preds, target, **kw))
    _close(tf.hinge_loss(*_t(preds, target), task="binary", **kw),
           jax.functional.hinge_loss(preds, target, task="binary", **kw))


@pytest.mark.parametrize("kind", ["probs", "logits"])
@pytest.mark.parametrize("ignore_index", [None, -1, 2])
@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("mode", ["crammer-singer", "one-vs-all"])
@pytest.mark.parametrize("extra", [(), (3,)], ids=["2d", "3d"])
def test_multiclass_hinge_matches_jax(jax, kind, ignore_index, squared, mode, extra):
    preds, target = _multiclass(kind, ignore_index, seed=len(kind) + len(mode) + int(squared), extra=extra)
    kw = dict(num_classes=NUM_CLASSES, squared=squared, multiclass_mode=mode, ignore_index=ignore_index)
    _close(tf.multiclass_hinge_loss(*_t(preds, target), **kw), jax.functional.multiclass_hinge_loss(preds, target, **kw))
    _close(tf.hinge_loss(*_t(preds, target), task="multiclass", **kw),
           jax.functional.hinge_loss(preds, target, task="multiclass", **kw))


HINGE_CLASSES = [
    ("BinaryHingeLoss", {}, "binary"),
    ("BinaryHingeLoss", {"squared": True, "ignore_index": -1}, "binary"),
    ("MulticlassHingeLoss", {"num_classes": NUM_CLASSES}, "multiclass"),
    ("MulticlassHingeLoss", {"num_classes": NUM_CLASSES, "multiclass_mode": "one-vs-all", "ignore_index": -1},
     "multiclass"),
    ("MulticlassHingeLoss", {"num_classes": NUM_CLASSES, "squared": True, "multiclass_mode": "one-vs-all"},
     "multiclass"),
]


@pytest.mark.parametrize("name,kwargs,task", HINGE_CLASSES, ids=[f"{c[0]}-{i}" for i, c in enumerate(HINGE_CLASSES)])
def test_hinge_class_matches_jax(jax, name, kwargs, task):
    ours, theirs = getattr(tc, name)(device="cpu", **kwargs), getattr(jax.classification, name)(**kwargs)
    make = _binary if task == "binary" else _multiclass
    batches = [make("logits", kwargs.get("ignore_index"), seed=20 + i) for i in range(3)]
    for preds, target in batches[:2]:
        _close(ours(*_t(preds, target)), theirs(preds, target))
    ours.update(*_t(*batches[2]))
    theirs.update(*batches[2])
    _close(ours.compute(), theirs.compute())
    for key in ("measures", "total"):
        got = ours.metric_state[key]
        assert got.dtype == torch.float32 and got.shape == np.asarray(theirs.metric_state[key]).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(theirs.metric_state[key]), rtol=RTOL)
    ours.reset()
    assert not ours.metric_state["total"]


@pytest.mark.parametrize("wrapper_kwargs,cls", [({"task": "binary"}, "BinaryHingeLoss"),
                                                ({"task": "multiclass", "num_classes": 3}, "MulticlassHingeLoss")])
def test_hinge_wrapper_builds_the_task_class(jax, wrapper_kwargs, cls):
    ours, theirs = tc.HingeLoss(device="cpu", **wrapper_kwargs), jax.classification.HingeLoss(**wrapper_kwargs)
    assert type(ours).__name__ == type(theirs).__name__ == cls


def test_hinge_errors_match_jax(jax):
    with pytest.raises(ValueError, match="multiclass_mode"):
        tc.MulticlassHingeLoss(3, multiclass_mode="all", device="cpu")
    with pytest.raises(ValueError, match="Invalid Classification task"):
        tc.HingeLoss(task="multilabel", device="cpu")
    with pytest.raises(RuntimeError, match="outside"):
        tf.multiclass_hinge_loss(torch.rand(4, 3), torch.tensor([0, 1, 2, 3]), 3)
    with pytest.raises(RuntimeError, match="Detected the following values in `target`"):
        tf.binary_hinge_loss(torch.rand(4), torch.tensor([0, 1, 2, 1]))


def _ranking_inputs(ignore_index, seed: int, n: int = 40, ties: bool = False):
    rng = np.random.RandomState(seed)
    preds = rng.rand(n, NUM_LABELS).astype(np.float32)
    if ties:
        preds = (np.round(preds * 3) / 3).astype(np.float32)
    target = rng.randint(0, 2, (n, NUM_LABELS))
    target[:3] = 0  # no relevant label
    target[3:5] = 1  # every label relevant
    if ignore_index is not None:
        target[rng.rand(n, NUM_LABELS) < 0.15] = ignore_index
    return preds, target


def _ranking_np(name: str, preds: np.ndarray, target: np.ndarray, ignore_index=None) -> float:
    """sklearn's definitions, one sample at a time, in float64; ignored labels are dropped."""
    values = []
    for p, t in zip(preds.astype(np.float64), target):
        keep = t != ignore_index if ignore_index is not None else np.ones(t.shape, bool)
        p, t = p[keep], t[keep]
        rel = t == 1
        if name == "multilabel_coverage_error":
            values.append(float(np.sum(p >= p[rel].min())) if rel.any() else 0.0)
        elif name == "multilabel_ranking_average_precision":
            if not rel.any() or rel.all():
                values.append(1.0)
                continue
            values.append(np.mean([np.sum(p[rel] >= p[i]) / np.sum(p >= p[i]) for i in np.flatnonzero(rel)]))
        else:
            pairs = rel.sum() * (~rel).sum()
            bad = sum(np.sum(p[~rel] >= p[i]) for i in np.flatnonzero(rel))
            values.append(bad / pairs if pairs else 0.0)
    return float(np.mean(values))


@pytest.mark.parametrize("name", RANKING)
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("ties", [False, True])
def test_ranking_functional_matches_jax_and_sklearn_loop(jax, name, ignore_index, ties):
    preds, target = _ranking_inputs(ignore_index, seed=len(name) + int(ties), ties=ties)
    kw = dict(num_labels=NUM_LABELS, ignore_index=ignore_index)
    ours = getattr(tf, name)(*_t(preds, target), **kw)
    _close(ours, getattr(jax.functional, name)(preds, target, **kw))
    np.testing.assert_allclose(float(ours), _ranking_np(name, preds, target, ignore_index), rtol=RTOL, atol=ATOL)


RANKING_CLASSES = ("MultilabelCoverageError", "MultilabelRankingAveragePrecision", "MultilabelRankingLoss")


@pytest.mark.parametrize("name", RANKING_CLASSES)
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_ranking_class_matches_jax(jax, name, ignore_index):
    ours = getattr(tc, name)(NUM_LABELS, ignore_index=ignore_index, device="cpu")
    theirs = getattr(jax.classification, name)(NUM_LABELS, ignore_index=ignore_index)
    batches = [_ranking_inputs(ignore_index, seed=30 + i, ties=bool(i % 2)) for i in range(3)]
    for preds, target in batches[:2]:
        _close(ours(*_t(preds, target)), theirs(preds, target))
    ours.update(*_t(*batches[2]))
    theirs.update(*batches[2])
    _close(ours.compute(), theirs.compute())
    assert float(ours.metric_state["total"]) == float(theirs.metric_state["total"]) == 120.0
    ours.reset()
    ours.update(*_t(*batches[0]))
    _close(ours.compute(), getattr(jax.functional, RANKING[RANKING_CLASSES.index(name)])(
        *batches[0], num_labels=NUM_LABELS, ignore_index=ignore_index))


def test_ranking_errors():
    with pytest.raises(ValueError, match="larger than 1"):
        tc.MultilabelRankingLoss(1, device="cpu")
    with pytest.raises(ValueError, match="float tensor"):
        tf.multilabel_coverage_error(torch.ones(2, 3, dtype=torch.int64), torch.ones(2, 3, dtype=torch.int64), 3)
    with pytest.raises(RuntimeError, match="Detected the following values in `target`"):
        tf.multilabel_ranking_loss(torch.rand(2, 3), torch.tensor([[0, 1, 2], [1, 1, 0]]), 3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", RANKING_CLASSES)
def test_ranking_on_the_card_matches_sklearn_loop(cuda_device, name):
    metric = getattr(tc, name)(NUM_LABELS, ignore_index=-1, device=cuda_device)
    preds, target = _ranking_inputs(-1, seed=40, n=2000, ties=True)
    metric.update(*_t(preds, target))
    want = _ranking_np(RANKING[RANKING_CLASSES.index(name)], preds, target, -1)
    np.testing.assert_allclose(float(metric.compute()), want, rtol=RTOL, atol=ATOL)
