"""The binned curve updates of the PyTorch port against the JAX package's, end to end.

Each case feeds the same numpy inputs through each package's ``_format`` and ``_update`` for
binary, multiclass (one-vs-rest and micro) and multilabel tasks. The port's update is one call of
K3's binned entry (on the CPU, its plain version); the JAX package's is its ``_binned_counts`` /
class-batched ``_indicator_counts``. The ``(T, ..., 2, 2)`` counts must be equal exactly.
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

ours = importlib.import_module("torchmetrics_tpu_torch.functional.classification.precision_recall_curve")

GRIDS = {"T=2": 2, "T=200": 200, "T=2048": 2048, "list": [0.0, 0.25, 0.25, 0.5, 1.0]}


@pytest.fixture(scope="module")
def jax_prc():
    jnp = pytest.importorskip("jax.numpy")
    return jnp, importlib.import_module("torchmetrics_tpu.functional.classification.precision_recall_curve")


def _scores(rng, shape, thresholds):
    """Probabilities with some exactly on a threshold, and a NaN, +inf and -inf among them."""
    scores = rng.rand(*shape).astype(np.float32)
    grid = np.linspace(0, 1, thresholds, dtype=np.float32) if isinstance(thresholds, int) else np.float32(thresholds)
    flat = scores.reshape(-1)
    on = rng.randint(0, flat.size, flat.size // 10)
    flat[on] = grid[rng.randint(0, grid.size, on.size)]
    flat[1], flat[3], flat[5] = np.nan, np.inf, -np.inf
    return scores


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_binary_update_matches_jax(jax_prc, grid, ignore_index):
    jnp, theirs = jax_prc
    thresholds = GRIDS[grid]
    rng = np.random.RandomState(1)
    preds = _scores(rng, (3000,), thresholds)
    target = rng.randint(0, 2, 3000)
    if ignore_index is not None:
        target[rng.rand(3000) < 0.1] = ignore_index
    p, t, thr = ours._binary_precision_recall_curve_format(torch.from_numpy(preds), torch.from_numpy(target), thresholds)
    got = ours._binary_precision_recall_curve_update(p, t, thr, ignore_index)
    jp, jt, jw, jthr = theirs._binary_precision_recall_curve_format(jnp.asarray(preds), jnp.asarray(target),
                                                                    thresholds, ignore_index)
    want = theirs._binary_precision_recall_curve_update(jp, jt, jw, jthr)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("average", [None, "micro"])
def test_multiclass_update_matches_jax(jax_prc, grid, ignore_index, average):
    jnp, theirs = jax_prc
    thresholds, num_classes = GRIDS[grid], 5
    rng = np.random.RandomState(2)
    preds = _scores(rng, (1500, num_classes), thresholds)
    target = rng.randint(0, num_classes, 1500)
    if ignore_index is not None:
        target[rng.rand(1500) < 0.1] = ignore_index
    p, t, thr = ours._multiclass_precision_recall_curve_format(torch.from_numpy(preds), torch.from_numpy(target),
                                                               num_classes, thresholds)
    got = ours._multiclass_precision_recall_curve_update(p, t, num_classes, thr, ignore_index, average)
    jp, jt, jw, jthr = theirs._multiclass_precision_recall_curve_format(
        jnp.asarray(preds), jnp.asarray(target), num_classes, thresholds, ignore_index, average
    )
    if average == "micro":  # the JAX package flattens one-vs-rest and counts it as binary
        want = theirs._binary_precision_recall_curve_update(jp, jt, jw, jthr)
    else:
        want = theirs._multiclass_precision_recall_curve_update(jp, jt, jw, num_classes, jthr)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multilabel_update_matches_jax(jax_prc, grid, ignore_index):
    jnp, theirs = jax_prc
    thresholds, num_labels = GRIDS[grid], 4
    rng = np.random.RandomState(3)
    preds = _scores(rng, (1000, num_labels), thresholds)
    target = rng.randint(0, 2, (1000, num_labels))
    if ignore_index is not None:
        target[rng.rand(1000, num_labels) < 0.1] = ignore_index
    p, t, thr = ours._multilabel_precision_recall_curve_format(torch.from_numpy(preds), torch.from_numpy(target),
                                                               num_labels, thresholds)
    got = ours._multilabel_precision_recall_curve_update(p, t, num_labels, thr, ignore_index)
    jp, jt, jw, jthr = theirs._multilabel_precision_recall_curve_format(
        jnp.asarray(preds), jnp.asarray(target), num_labels, thresholds, ignore_index
    )
    want = theirs._multilabel_precision_recall_curve_update(jp, jt, jw, num_labels, jthr)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_exact_state_matches_jax_format(jax_prc):
    # exact mode keeps the JAX package's (preds, target01, weight) state
    jnp, theirs = jax_prc
    rng = np.random.RandomState(4)
    preds = rng.rand(200).astype(np.float32)
    target = rng.randint(0, 2, 200)
    target[::7] = -1
    p, t, _ = ours._binary_precision_recall_curve_format(torch.from_numpy(preds), torch.from_numpy(target))
    state = ours._exact_state(p, t, -1)
    want = theirs._binary_precision_recall_curve_format(jnp.asarray(preds), jnp.asarray(target), None, -1)[:3]
    for got, exp in zip(state, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    p, t, _ = ours._multiclass_precision_recall_curve_format(
        torch.from_numpy(rng.rand(50, 3).astype(np.float32)), torch.from_numpy(rng.randint(-1, 3, 50)), 3
    )
    flat = ours._micro_exact_state(p, t, 3, -1)
    want = theirs._multiclass_precision_recall_curve_format(jnp.asarray(p.numpy()), jnp.asarray(t.numpy()), 3, None,
                                                            -1, "micro")[:3]
    for got, exp in zip(flat, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
