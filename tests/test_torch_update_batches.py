"""``update_batches`` of the PyTorch port (``Metric`` and ``MetricCollection``) against the JAX
package's, on the same stacked numpy batches from a seed.

The collections of paths A (multiclass stat scores), E (binary stat scores) and F (binned
fixed-point metrics with ``BinaryAUROC``) and ``MeanMetric`` fold a stack in one call. Each runs on
the eager tier and on the graph tier's bookkeeping (``dispatch.EMULATE_ON_CPU``). Counts must equal
JAX's exactly; stat-score values match within 1e-6, curve values within 1e-5, aggregation values
within rtol 1e-5 (the summation order differs). The port's own per-batch ``update`` loop must give
bit-identical state. Groups form from the first batch, list states fold with a loop of updates,
and validation reads the stack once and raises JAX's errors.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.aggregation as ja
import torchmetrics_tpu.classification as jc
import torchmetrics_tpu_torch.aggregation as ta
import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu import MetricCollection as JaxCollection
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.ops import dispatch


@pytest.fixture(params=["eager", "graph"])
def tier(request, monkeypatch):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", request.param == "graph")
    dispatch.STATS.reset()
    return request.param


def path_a(pkg, **kw):
    kw = dict(num_classes=5, validate_args=False, **kw)
    return [pkg.MulticlassAccuracy(average="micro", **kw), pkg.MulticlassPrecision(**kw), pkg.MulticlassRecall(**kw),
            pkg.MulticlassF1Score(**kw)]


def path_e(pkg, **kw):
    return [pkg.BinaryAccuracy(**kw), pkg.BinaryPrecision(**kw), pkg.BinaryRecall(**kw), pkg.BinaryF1Score(**kw)]


def path_f(pkg, **kw):
    return [pkg.BinaryRecallAtFixedPrecision(0.5, thresholds=200, **kw), pkg.BinaryPrecisionAtFixedRecall(0.5, thresholds=200, **kw),
            pkg.BinarySpecificityAtSensitivity(0.5, thresholds=200, **kw), pkg.BinaryAUROC(thresholds=200, **kw)]


PATHS = {"A": (path_a, "labels", ("tp", "fp", "tn", "fn"), 1e-6), "E": (path_e, "binary", ("tp", "fp", "tn", "fn"), 1e-6),
         "F": (path_f, "binary", ("confmat",), 1e-5)}


def stack(kind: str, n_batches: int = 5, batch: int = 300, seed: int = 0):
    rng = np.random.RandomState(seed)
    if kind == "labels":
        preds = rng.randint(0, 5, (n_batches, batch)).astype(np.int32)
        target = rng.randint(0, 5, (n_batches, batch)).astype(np.int32)
    else:
        preds = rng.rand(n_batches, batch).astype(np.float32)
        target = rng.randint(0, 2, (n_batches, batch)).astype(np.int32)
    return preds, target


def assert_values(ours: dict, theirs: dict, tol: float) -> None:
    assert sorted(ours) == sorted(theirs)
    for key, value in ours.items():
        for o, t in zip(value if isinstance(value, tuple) else (value,), theirs[key] if isinstance(value, tuple) else (theirs[key],)):
            np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=tol, atol=tol, err_msg=key)


def assert_counts(port: MetricCollection, theirs, keys) -> None:
    for name in port._modules:
        ours, want = port[name].metric_state, theirs[name].metric_state
        for key in keys:
            np.testing.assert_array_equal(ours[key].numpy(), np.asarray(want[key]), err_msg=f"{name}.{key}")


@pytest.mark.parametrize("path", sorted(PATHS))
def test_collection_update_batches_matches_jax(tier, path):
    members, kind, keys, tol = PATHS[path]
    preds, target = stack(kind)
    port, theirs = MetricCollection(members(tc, device="cpu")), JaxCollection(members(jc))
    port.update_batches(torch.from_numpy(preds), torch.from_numpy(target))
    theirs.update_batches(jnp.asarray(preds), jnp.asarray(target))
    assert port.compute_groups == theirs.compute_groups and len(port.compute_groups) == 1  # formed from batch 0
    assert_counts(port, theirs, keys)
    assert_values(port.compute(), theirs.compute(), tol)
    # a second sweep after a reset folds all five batches at once
    port.reset()
    theirs.reset()
    preds, target = stack(kind, seed=1)
    port.update_batches(torch.from_numpy(preds), torch.from_numpy(target))
    theirs.update_batches(jnp.asarray(preds), jnp.asarray(target))
    assert_counts(port, theirs, keys)
    assert_values(port.compute(), theirs.compute(), tol)
    if tier == "graph":  # one replay per sweep; only the first batch's plain updates were eager
        assert dispatch.STATS.replays == 2
        assert {reason for _, op, reason in dispatch.STATS.fallbacks} == {"fast_update_class_off"}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_update_batches_equals_the_update_loop(tier, path):
    members, kind, keys, _ = PATHS[path]
    preds, target = (torch.from_numpy(a) for a in stack(kind))
    swept, looped = MetricCollection(members(tc, device="cpu")), MetricCollection(members(tc, device="cpu"))
    swept.update_batches(preds, target)
    for p, t in zip(preds, target):
        looped.update(p, t)
    for name in swept._modules:
        for key in keys:
            assert torch.equal(swept[name].metric_state[key], looped[name].metric_state[key])
    for name, value in swept.compute().items():
        want = looped.compute()[name]
        assert all(torch.equal(a, b) for a, b in zip(value, want)) if isinstance(value, tuple) else torch.equal(value, want)


@pytest.mark.parametrize("weighted", [False, True])
def test_mean_metric_update_batches_matches_jax(tier, weighted):
    rng = np.random.RandomState(4)
    values = rng.randn(6, 50).astype(np.float32)
    values[2, 7] = np.nan
    weight = rng.rand(6, 50).astype(np.float32) if weighted else None
    kwargs = {} if weight is None else {"weight": weight}
    ours, theirs = ta.MeanMetric(nan_strategy="ignore", device="cpu"), ja.MeanMetric(nan_strategy="ignore")
    ours.update_batches(torch.from_numpy(values), **{k: torch.from_numpy(v) for k, v in kwargs.items()})
    theirs.update_batches(jnp.asarray(values), **{k: jnp.asarray(v) for k, v in kwargs.items()})
    assert ours.update_count == theirs.update_count == 6
    np.testing.assert_allclose(ours.compute().numpy(), np.asarray(theirs.compute()), rtol=1e-5)
    for key in ("mean_value", "weight"):
        np.testing.assert_allclose(ours.metric_state[key].numpy(), np.asarray(theirs.metric_state[key]), rtol=1e-5)


def test_list_states_fold_with_a_loop_of_updates(tier):
    preds, target = stack("binary", n_batches=3, batch=40)
    ours, theirs = tc.BinaryAUROC(device="cpu"), jc.BinaryAUROC()  # exact mode: list states
    ours.update_batches(torch.from_numpy(preds), torch.from_numpy(target))
    theirs.update_batches(jnp.asarray(preds), jnp.asarray(target))
    assert ours.update_count == theirs.update_count == 3 and len(ours.metric_state["preds"]) == 3
    np.testing.assert_allclose(ours.compute().numpy(), np.asarray(theirs.compute()), rtol=1e-5, atol=1e-5)
    assert dispatch.STATS.fallbacks[("BinaryAUROC", "update_batches", "list_state")] == 1


def test_validation_reads_the_stack_and_raises_jax_errors(tier):
    preds, target = stack("labels", n_batches=4, batch=50)
    target[2, 5] = 7  # out of range for C = 5, in the third batch
    kw = dict(num_classes=5, validate_args=True)
    with pytest.raises(RuntimeError) as theirs:
        jc.MulticlassF1Score(**kw).update_batches(jnp.asarray(preds), jnp.asarray(target))
    ours = tc.MulticlassF1Score(device="cpu", **kw)
    with pytest.raises(type(theirs.value), match=str(theirs.value)[:40]):
        ours.update_batches(torch.from_numpy(preds), torch.from_numpy(target))
    assert ours.update_count == 0 and int(ours.metric_state["tp"].sum()) == 0
