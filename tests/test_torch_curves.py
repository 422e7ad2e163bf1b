"""The functional curve family of the PyTorch port (PR curve, ROC, AUROC, AP) against the JAX package.

The same numpy inputs go through ``torchmetrics_tpu.functional`` and its counterpart in the port,
for binary, multiclass and multilabel tasks, thresholds None (exact mode), int, list and array
(binned mode), ``ignore_index`` and ``max_fpr``. The JAX package counts on the CPU through its own
lowering of ``_indicator_counts``; the port through K3's plain version.

The JAX side runs op by op (``jax.disable_jit``), so that its primitives compile once for the file rather
than each configuration once.

Tolerance: curve points and scores within atol 1e-6 (float32 divisions and sums taken in another
order; exact mode is float64 on the host in both, rounded to float32). Inputs that are already
probabilities give the same counts in both, so the binned curves agree to that tolerance at every
point. Logit inputs pass through sigmoid or softmax, which differ in the last ulp between torch
and XLA; they are held by value within the same tolerance.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.classification as jf
import torchmetrics_tpu_torch.functional as tf
from torchmetrics_tpu.utils.compute import normalize_logits_if_needed as jax_normalize
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _adjust_threshold_arg
from torchmetrics_tpu_torch.utils.compute import _auc_compute, normalize_logits_if_needed
from tests.test_torch_curve_metrics import ATOL, assert_close
from torch_jax_pool import jax_op_by_op  # noqa: F401  (autouse: the JAX side op by op)
#: a case that keeps JAX's jit on (``jax_op_by_op``), so the port is held to JAX's traced branches too
JAX_JITTED_CASES = ('test_binary_curve_family[False--1-int]',)

THRESHOLDS = {
    "exact": None,
    "int": 50,
    "list": [0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0],
    "array": np.random.RandomState(9).rand(23).astype(np.float32),  # unsorted: both sort it
}


def _binary_inputs(n: int, seed: int, logits: bool = False, ignore_index=None):
    rng = np.random.RandomState(seed)
    preds = rng.randn(n).astype(np.float32) * 2 if logits else rng.rand(n).astype(np.float32)
    if not logits:
        preds[::17] = np.round(preds[::17] * 49) / 49  # some scores on the int grid's knots
    target = (rng.rand(n) < 0.4).astype(np.int64)
    if ignore_index is not None:
        target[rng.rand(n) < 0.1] = ignore_index
    return preds, target


def _multiclass_inputs(n: int, num_classes: int, seed: int, logits: bool = False, ignore_index=None, extra=()):
    rng = np.random.RandomState(seed)
    shape = (n, num_classes, *extra)
    preds = rng.randn(*shape).astype(np.float32)
    if not logits:
        preds = np.exp(preds) / np.exp(preds).sum(axis=1, keepdims=True)
        preds = preds.astype(np.float32)
    target = rng.randint(0, num_classes, (n, *extra))
    if ignore_index is not None:
        target[rng.rand(*target.shape) < 0.1] = ignore_index
    return preds, target


def _multilabel_inputs(n: int, num_labels: int, seed: int, logits: bool = False, ignore_index=None):
    rng = np.random.RandomState(seed)
    preds = rng.randn(n, num_labels).astype(np.float32) if logits else rng.rand(n, num_labels).astype(np.float32)
    target = (rng.rand(n, num_labels) < 0.5).astype(np.int64)
    if ignore_index is not None:
        target[rng.rand(n, num_labels) < 0.1] = ignore_index
    return preds, target


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("thresholds", list(THRESHOLDS))
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("logits", [False, True])
def test_binary_curve_family(thresholds, ignore_index, logits):
    thr = THRESHOLDS[thresholds]
    preds, target = _binary_inputs(300, seed=1, logits=logits, ignore_index=ignore_index)
    kw = dict(thresholds=thr, ignore_index=ignore_index)
    assert_close(tf.binary_precision_recall_curve(_t(preds), _t(target), **kw),
                 jf.binary_precision_recall_curve(preds, target, **kw))
    assert_close(tf.binary_roc(_t(preds), _t(target), **kw), jf.binary_roc(preds, target, **kw))
    assert_close(tf.binary_average_precision(_t(preds), _t(target), **kw),
                 jf.binary_average_precision(preds, target, **kw))
    for max_fpr in (None, 0.3, 1.0):
        assert_close(tf.binary_auroc(_t(preds), _t(target), max_fpr=max_fpr, **kw),
                     jf.binary_auroc(preds, target, max_fpr=max_fpr, **kw))


@pytest.mark.parametrize("thresholds", list(THRESHOLDS))
@pytest.mark.parametrize("ignore_index", [None, 1])
def test_multiclass_curve_family(thresholds, ignore_index):
    thr = THRESHOLDS[thresholds]
    preds, target = _multiclass_inputs(240, 4, seed=2, ignore_index=ignore_index)
    kw = dict(thresholds=thr, ignore_index=ignore_index)
    for average in (None, "micro"):
        assert_close(tf.multiclass_precision_recall_curve(_t(preds), _t(target), 4, average=average, **kw),
                     jf.multiclass_precision_recall_curve(preds, target, 4, average=average, **kw))
        assert_close(tf.multiclass_roc(_t(preds), _t(target), 4, average=average, **kw),
                     jf.multiclass_roc(preds, target, 4, average=average, **kw))
    for average in (None, "macro", "weighted"):
        assert_close(tf.multiclass_auroc(_t(preds), _t(target), 4, average=average, **kw),
                     jf.multiclass_auroc(preds, target, 4, average=average, **kw))
        assert_close(tf.multiclass_average_precision(_t(preds), _t(target), 4, average=average, **kw),
                     jf.multiclass_average_precision(preds, target, 4, average=average, **kw))


@pytest.mark.parametrize("thresholds", ["exact", "int"])
def test_multiclass_logits_and_extra_dims(thresholds):
    thr = THRESHOLDS[thresholds]
    preds, target = _multiclass_inputs(40, 3, seed=3, logits=True, extra=(5,))  # (N, C, S): softmax on C
    assert_close(tf.multiclass_auroc(_t(preds), _t(target), 3, thresholds=thr),
                 jf.multiclass_auroc(preds, target, 3, thresholds=thr))
    assert_close(tf.multiclass_roc(_t(preds), _t(target), 3, thresholds=thr),
                 jf.multiclass_roc(preds, target, 3, thresholds=thr))


@pytest.mark.parametrize("thresholds", list(THRESHOLDS))
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multilabel_curve_family(thresholds, ignore_index):
    thr = THRESHOLDS[thresholds]
    preds, target = _multilabel_inputs(200, 3, seed=4, ignore_index=ignore_index)
    kw = dict(thresholds=thr, ignore_index=ignore_index)
    assert_close(tf.multilabel_precision_recall_curve(_t(preds), _t(target), 3, **kw),
                 jf.multilabel_precision_recall_curve(preds, target, 3, **kw))
    assert_close(tf.multilabel_roc(_t(preds), _t(target), 3, **kw), jf.multilabel_roc(preds, target, 3, **kw))
    for average in (None, "micro", "macro", "weighted"):
        assert_close(tf.multilabel_auroc(_t(preds), _t(target), 3, average=average, **kw),
                     jf.multilabel_auroc(preds, target, 3, average=average, **kw))
        assert_close(tf.multilabel_average_precision(_t(preds), _t(target), 3, average=average, **kw),
                     jf.multilabel_average_precision(preds, target, 3, average=average, **kw))


@pytest.mark.parametrize("task,kwargs", [
    ("binary", {}), ("multiclass", {"num_classes": 3}), ("multilabel", {"num_labels": 3}),
])
def test_task_entries_dispatch(task, kwargs):
    if task == "binary":
        preds, target = _binary_inputs(100, seed=5)
    elif task == "multiclass":
        preds, target = _multiclass_inputs(100, 3, seed=5)
    else:
        preds, target = _multilabel_inputs(100, 3, seed=5)
    for name in ("precision_recall_curve", "roc", "auroc", "average_precision"):
        assert_close(getattr(tf, name)(_t(preds), _t(target), task=task, thresholds=20, **kwargs),
                     getattr(jf, name)(preds, target, task=task, thresholds=20, **kwargs))
    with pytest.raises(ValueError, match="Invalid Classification task"):
        tf.auroc(_t(preds), _t(target), task="nope")


def test_degenerate_targets_warn_and_match():
    preds = np.array([0.1, 0.4, 0.8], np.float32)
    target = np.zeros(3, np.int64)
    with pytest.warns(UserWarning, match="No positive samples"):
        ours = tf.binary_roc(_t(preds), _t(target))
    assert_close(ours, jf.binary_roc(preds, target))
    for thr in (None, 10):
        assert_close(tf.binary_auroc(_t(preds), _t(target), thresholds=thr), jf.binary_auroc(preds, target, thresholds=thr))
        assert_close(tf.binary_average_precision(_t(preds), _t(target), thresholds=thr),
                     jf.binary_average_precision(preds, target, thresholds=thr))


@pytest.mark.parametrize("preds,target,kwargs,error", [
    (np.array([0.2, 0.7], np.float32), np.array([0, 2]), {}, RuntimeError),
    (np.array([1, 0]), np.array([0, 1]), {}, ValueError),
    (np.array([0.2, 0.7], np.float32), np.array([0, 1]), {"thresholds": 1}, ValueError),
    (np.array([0.2, 0.7], np.float32), np.array([0, 1]), {"thresholds": [0.5, 2.0]}, ValueError),
    (np.array([0.2, 0.7], np.float32), np.array([0, 1]), {"max_fpr": 1.5}, ValueError),
])
def test_validation_raises_like_jax(preds, target, kwargs, error):
    with pytest.raises(error):
        jf.binary_auroc(preds, target, **kwargs)
    with pytest.raises(error):
        tf.binary_auroc(_t(preds), _t(target), **kwargs)


@pytest.mark.parametrize("thresholds", [2, 200, 2048, [0.5, 0.25, 0.75]])
def test_threshold_grid_is_numpys(thresholds):
    # the grid is built in float32 numpy as in the JAX package, never with torch.linspace
    grid = _adjust_threshold_arg(thresholds)
    want = np.linspace(0, 1, thresholds, dtype=np.float32) if isinstance(thresholds, int) else np.sort(np.float32(thresholds))
    assert grid.dtype == torch.float32
    np.testing.assert_array_equal(grid.numpy(), want)


@pytest.mark.parametrize("normalization,shape", [("sigmoid", (50,)), ("softmax", (20, 4))])
@pytest.mark.parametrize("kind", ["probabilities", "logits", "empty"])
def test_normalize_logits_if_needed(normalization, shape, kind):
    rng = np.random.RandomState(0)
    x = rng.rand(*shape).astype(np.float32) if kind == "probabilities" else rng.randn(*shape).astype(np.float32) * 3
    if kind == "empty":
        x = x[:0]
    ours = normalize_logits_if_needed(_t(x), normalization)
    if kind == "empty":
        assert ours.shape == x.shape
        return
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_normalize(x, normalization)), rtol=0, atol=ATOL)
    if kind == "probabilities":
        np.testing.assert_array_equal(ours.numpy(), x)  # untouched, bit for bit


def test_auc_compute_reorders():
    x = np.array([0.5, 0.0, 1.0, 0.25], np.float32)
    y = np.array([0.5, 0.0, 1.0, 0.5], np.float32)
    from torchmetrics_tpu.utils.compute import _auc_compute as jax_auc

    for reorder in (True, False):
        np.testing.assert_allclose(_auc_compute(_t(x), _t(y), reorder).numpy(), np.asarray(jax_auc(x, y, reorder)), atol=ATOL)
