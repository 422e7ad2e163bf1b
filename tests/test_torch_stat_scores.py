"""Functional multiclass stat scores, accuracy, precision, recall and F1 of the PyTorch port
against the JAX package, on the same numpy inputs.

Counts must be equal exactly. Ratios must agree within rtol=1e-6, atol=1e-7: both packages
divide float32 counts, and the class averages may sum in another order.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional as jf
import torchmetrics_tpu_torch.functional as tf
from torchmetrics_tpu.functional.classification.stat_scores import (
    _multiclass_stat_scores_format as jax_format,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_format as torch_format,
)

NUM_CLASSES = 5
RATIOS = ("multiclass_accuracy", "multiclass_precision", "multiclass_recall", "multiclass_f1_score")


def _inputs(kind: str, multidim_average: str, ignore_index, seed: int):
    rng = np.random.RandomState(seed)
    n, extra = 64, 6
    shape = (n,) if multidim_average == "global" else (n, extra)
    target = rng.randint(0, NUM_CLASSES, shape)
    if ignore_index is not None:
        target[rng.rand(*shape) < 0.1] = ignore_index
    if kind == "labels":
        preds = rng.randint(0, NUM_CLASSES, shape)
    else:
        preds = rng.randn(n, NUM_CLASSES, *shape[1:]).astype(np.float32)
    return preds, target


CASES = [
    (kind, top_k)
    for kind in ("labels", "logits")
    for top_k in (1, 2)
    if not (kind == "labels" and top_k == 2)  # top_k > 1 needs scores
]


@pytest.mark.parametrize("kind,top_k", CASES)
@pytest.mark.parametrize("ignore_index", [None, -1, 0])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
def test_functional_matches_jax(kind, top_k, ignore_index, average, multidim_average):
    preds, target = _inputs(kind, multidim_average, ignore_index, seed=top_k * 7 + (ignore_index or 0) + 3)
    kwargs = dict(num_classes=NUM_CLASSES, average=average, top_k=top_k,
                  multidim_average=multidim_average, ignore_index=ignore_index)
    ours = tf.multiclass_stat_scores(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    theirs = np.asarray(jf.multiclass_stat_scores(jnp.asarray(preds), jnp.asarray(target), **kwargs))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    for name in RATIOS:
        ours = getattr(tf, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
        theirs = np.asarray(getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs))
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-6, atol=1e-7, err_msg=name)


def test_argmax_ties_take_the_first_maximum():
    logits = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0], [0.0, -1.0, 5.0, 5.0]], np.float32)
    target = np.array([1, 0, 2])
    ours, _ = torch_format(torch.from_numpy(logits), torch.from_numpy(target))
    theirs, _ = jax_format(jnp.asarray(logits), jnp.asarray(target))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    np.testing.assert_array_equal(ours.numpy().ravel(), [1, 0, 2])


def test_int64_labels_equal_int32_labels():
    rng = np.random.RandomState(4)
    preds, target = rng.randint(0, NUM_CLASSES, 500), rng.randint(0, NUM_CLASSES, 500)
    wide = tf.multiclass_stat_scores(torch.from_numpy(preds), torch.from_numpy(target), NUM_CLASSES)
    narrow = tf.multiclass_stat_scores(
        torch.from_numpy(preds.astype(np.int32)), torch.from_numpy(target.astype(np.int32)), NUM_CLASSES
    )
    assert torch.equal(wide, narrow)


@pytest.mark.parametrize(
    "preds,target,kwargs,error",
    [
        (np.array([0, 1, 5]), np.array([0, 1, 2]), {}, RuntimeError),  # preds out of range
        (np.array([0, 1, 2]), np.array([0, 1, 7]), {}, RuntimeError),  # target out of range
        (np.array([0, 1]), np.array([0, 1, 2]), {}, ValueError),  # shapes differ
        (np.array([0, 1, 2]), np.array([0, 1, 2]), {"top_k": 2}, ValueError),  # top_k on labels
        (np.array([0, 1, 2]), np.array([0, 1, 2]), {"average": "mean"}, ValueError),
    ],
)
def test_validation_raises_like_jax(preds, target, kwargs, error):
    with pytest.raises(error):
        jf.multiclass_stat_scores(jnp.asarray(preds), jnp.asarray(target), NUM_CLASSES, **kwargs)
    with pytest.raises(error):
        tf.multiclass_stat_scores(torch.from_numpy(preds), torch.from_numpy(target), NUM_CLASSES, **kwargs)
