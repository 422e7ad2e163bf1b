"""The port's wrappers against the JAX package's, on the same seeded numpy inputs.

The cases of ``tests/unittests/wrappers/test_wrappers.py`` (its 17 tests), each run through both
packages: ``BootStrapper`` (value for value under one seed, both sampling strategies: the port draws
JAX's ``RandomState`` stream), ``ClasswiseWrapper``, ``MinMaxMetric``, ``MultioutputWrapper``
(``remove_nans``, ``squeeze_outputs``), ``MultitaskWrapper``, ``Running`` and ``MetricTracker``
(``increment``, ``compute_all``, ``best_metric`` with ``maximize`` per key). Values agree within
1e-6 relative; ``BootStrapper``'s std and quantiles within 1e-5.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as port
import torchmetrics_tpu_torch.aggregation as port_aggregation
import torchmetrics_tpu_torch.classification as port_classification
import torchmetrics_tpu_torch.regression as port_regression
import torchmetrics_tpu_torch.wrappers as port_wrappers

NB, BS, C = 4, 32, 3
rng = np.random.RandomState(11)
PREDS = rng.rand(NB, BS).astype(np.float32)
TARGET = rng.randint(0, 2, (NB, BS))
MC_PREDS = rng.rand(NB, BS, C).astype(np.float32)
MC_TARGET = rng.randint(0, C, (NB, BS))
MO_PREDS = rng.rand(NB, BS, 2).astype(np.float32)
MO_TARGET = rng.rand(NB, BS, 2).astype(np.float32)
NOISE = rng.rand(3, NB, BS).astype(np.float32)


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import torchmetrics_tpu.aggregation as ja
    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu.regression as jr
    import torchmetrics_tpu.wrappers as jw
    from torchmetrics_tpu.collections import MetricCollection

    return SimpleNamespace(asarray=jnp.asarray, aggregation=ja, classification=jc, regression=jr, wrappers=jw,
                           MetricCollection=MetricCollection, device={})


PORT = SimpleNamespace(asarray=torch.from_numpy, aggregation=port_aggregation, classification=port_classification,
                       regression=port_regression, wrappers=port_wrappers, MetricCollection=port.MetricCollection,
                       device={"device": "cpu"})


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _close(ours, theirs, rtol=1e-6):
    ours, theirs = _np(ours), _np(theirs)
    if isinstance(ours, dict):
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            _close(ours[k], theirs[k], rtol)
        return
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=rtol, atol=rtol * 0.1)


def both(jax, fn):
    """``fn(ns)`` run through the port and through the JAX package."""
    return fn(PORT), fn(jax)


def _asarray(ns, x):
    return ns.asarray(np.ascontiguousarray(x))


# ------------------------------------------------------------------ BootStrapper
def test_bootstrapper_output_keys_and_sanity(jax):
    def run(ns):
        wrapper = ns.wrappers.BootStrapper(ns.classification.BinaryAccuracy(**ns.device), num_bootstraps=8,
                                           quantile=0.95, raw=True, seed=0)
        for i in range(NB):
            wrapper.update(_asarray(ns, PREDS[i]), _asarray(ns, TARGET[i]))
        base = ns.classification.BinaryAccuracy(**ns.device)
        for i in range(NB):
            base.update(_asarray(ns, PREDS[i]), _asarray(ns, TARGET[i]))
        return wrapper.compute(), base.compute()

    (out, base), (jout, _) = both(jax, run)
    assert set(out) == {"mean", "std", "quantile", "raw"} and tuple(out["raw"].shape) == (8,)
    np.testing.assert_allclose(float(out["mean"]), float(base), atol=0.1)
    _close(out, jout, 1e-5)


def test_bootstrapper_seed_reproducible(jax):
    def run(ns, seed):
        w = ns.wrappers.BootStrapper(ns.classification.BinaryAccuracy(**ns.device), num_bootstraps=6, seed=seed, raw=True)
        for i in range(NB):
            w.update(_asarray(ns, PREDS[i]), _asarray(ns, TARGET[i]))
        return _np(w.compute()["raw"])

    first, second, other = run(PORT, 123), run(PORT, 123), run(PORT, 321)
    np.testing.assert_array_equal(first, second)
    assert not np.array_equal(first, other)
    np.testing.assert_allclose(first, run(jax, 123), rtol=1e-6)


def test_bootstrapper_seed_survives_reset(jax):
    def run(ns):
        w = ns.wrappers.BootStrapper(ns.classification.BinaryAccuracy(**ns.device), num_bootstraps=6, seed=123, raw=True)
        for i in range(NB):
            w.update(_asarray(ns, PREDS[i]), _asarray(ns, TARGET[i]))
        first = _np(w.compute()["raw"])
        w.reset()
        for i in range(NB):
            w.update(_asarray(ns, PREDS[i]), _asarray(ns, TARGET[i]))
        return first, _np(w.compute()["raw"])

    (first, again), (jfirst, _) = both(jax, run)
    np.testing.assert_array_equal(first, again)
    np.testing.assert_allclose(first, jfirst, rtol=1e-6)


@pytest.mark.parametrize("sampling_strategy", ["poisson", "multinomial"])
def test_bootstrapper_sampling_strategies(jax, sampling_strategy):
    """Value for value under one seed: the same resamples as the JAX package's, then the same
    mean, std (``correction=1``), quantiles (linear) and raw values."""
    def run(ns):
        w = ns.wrappers.BootStrapper(ns.classification.MulticlassAccuracy(num_classes=C, **ns.device), num_bootstraps=7,
                                     sampling_strategy=sampling_strategy, seed=7, quantile=[0.05, 0.5, 0.95], raw=True)
        for i in range(NB):
            w.update(_asarray(ns, MC_PREDS[i]), _asarray(ns, MC_TARGET[i]))
        return w.compute()

    ours, theirs = both(jax, run)
    assert 0.0 <= float(ours["mean"]) <= 1.0
    _close(ours["raw"], theirs["raw"], 1e-6)
    _close(ours, theirs, 1e-5)


# ------------------------------------------------------------------ ClasswiseWrapper
def test_classwise_labels_and_prefix(jax):
    def run(ns):
        w = ns.wrappers.ClasswiseWrapper(ns.classification.MulticlassAccuracy(num_classes=C, average=None, **ns.device),
                                         labels=["a", "b", "c"])
        w.update(_asarray(ns, MC_PREDS[0]), _asarray(ns, MC_TARGET[0]))
        w2 = ns.wrappers.ClasswiseWrapper(ns.classification.MulticlassAccuracy(num_classes=C, average=None, **ns.device),
                                          labels=["a", "b", "c"], prefix="acc-")
        w2.update(_asarray(ns, MC_PREDS[0]), _asarray(ns, MC_TARGET[0]))
        return w.compute(), w2.compute()

    (out, out2), (jout, jout2) = both(jax, run)
    assert set(out) == {"multiclassaccuracy_a", "multiclassaccuracy_b", "multiclassaccuracy_c"}
    assert set(out2) == {"acc-a", "acc-b", "acc-c"}
    _close(out, jout)
    _close(out2, jout2)


def test_classwise_values_match_unwrapped(jax):
    def run(ns):
        w = ns.wrappers.ClasswiseWrapper(ns.classification.MulticlassAccuracy(num_classes=C, average=None, **ns.device))
        base = ns.classification.MulticlassAccuracy(num_classes=C, average=None, **ns.device)
        batch_values = []
        for i in range(NB):
            batch_values.append(w(_asarray(ns, MC_PREDS[i]), _asarray(ns, MC_TARGET[i])))
            base.update(_asarray(ns, MC_PREDS[i]), _asarray(ns, MC_TARGET[i]))
        return w.compute(), base.compute(), batch_values

    (out, base, batches), (jout, _, jbatches) = both(jax, run)
    np.testing.assert_allclose(np.asarray([float(v) for v in out.values()]), base.numpy(), atol=1e-6)
    _close(out, jout)
    for b, jb in zip(batches, jbatches):
        _close(b, jb)


# ------------------------------------------------------------------ MinMaxMetric
def test_minmax_tracks_extrema(jax):
    def run(ns):
        w = ns.wrappers.MinMaxMetric(ns.aggregation.MeanMetric(**ns.device))
        seen = []
        for v in [2.0, 5.0, 1.0]:
            w.update(_asarray(ns, np.asarray([v], np.float32)))
            out = w.compute()
            seen.append((float(out["raw"]), float(out["min"]), float(out["max"])))
        return seen

    seen, jseen = both(jax, run)
    np.testing.assert_allclose([s[0] for s in seen], [2.0, 3.5, 8 / 3], atol=1e-6)
    assert seen[-1][1:] == (2.0, 3.5)
    np.testing.assert_allclose(seen, jseen, rtol=1e-6)


def test_minmax_reset(jax):
    def run(ns):
        w = ns.wrappers.MinMaxMetric(ns.aggregation.MeanMetric(**ns.device))
        first = w(_asarray(ns, np.asarray([4.0], np.float32)))
        w.reset()
        return first, float(w.min_val), float(w.max_val)

    (first, lo, hi), (jfirst, jlo, jhi) = both(jax, run)
    assert (lo, hi) == (jlo, jhi) == (float("inf"), float("-inf"))
    _close(first, jfirst)


# ------------------------------------------------------------------ MultioutputWrapper
@pytest.mark.parametrize("squeeze_outputs", [True, False])
def test_multioutput_matches_per_column(jax, squeeze_outputs):
    def run(ns):
        w = ns.wrappers.MultioutputWrapper(ns.regression.MeanSquaredError(**ns.device), num_outputs=2,
                                           squeeze_outputs=squeeze_outputs)
        batch = [w(_asarray(ns, MO_PREDS[i]), _asarray(ns, MO_TARGET[i])) for i in range(NB)]
        return w.compute(), batch

    (out, batch), (jout, jbatch) = both(jax, run)
    for col in range(2):
        ref = np.mean((MO_PREDS[..., col] - MO_TARGET[..., col]) ** 2)
        np.testing.assert_allclose(out.numpy().reshape(2)[col], ref, atol=1e-6)
    _close(out, jout)
    for b, jb in zip(batch, jbatch):
        _close(b, jb)


def test_multioutput_remove_nans(jax):
    preds = np.asarray([[1.0, 2.0], [np.nan, 3.0], [2.0, 4.0]], np.float32)
    target = np.asarray([[1.0, 2.0], [5.0, 3.0], [1.0, 2.0]], np.float32)

    def run(ns):
        w = ns.wrappers.MultioutputWrapper(ns.regression.MeanSquaredError(**ns.device), num_outputs=2)
        w.update(_asarray(ns, preds), _asarray(ns, target))
        return w.compute()

    out, jout = both(jax, run)
    np.testing.assert_allclose(out[0], np.mean((np.asarray([1.0, 2.0]) - np.asarray([1.0, 1.0])) ** 2), atol=1e-6)
    np.testing.assert_allclose(out[1], np.mean((preds[:, 1] - target[:, 1]) ** 2), atol=1e-6)
    _close(out, jout)


# ------------------------------------------------------------------ MultitaskWrapper
def test_multitask_dict_in_dict_out(jax):
    def run(ns):
        w = ns.wrappers.MultitaskWrapper({"cls": ns.classification.BinaryAccuracy(**ns.device),
                                          "reg": ns.regression.MeanSquaredError(**ns.device)})
        preds = {"cls": _asarray(ns, PREDS[0]), "reg": _asarray(ns, PREDS[0])}
        target = {"cls": _asarray(ns, TARGET[0]), "reg": _asarray(ns, PREDS[0] * 0.9)}
        batch = w(preds, target)
        w.update(preds, target)
        return w.compute(), batch

    (out, batch), (jout, jbatch) = both(jax, run)
    assert set(out) == {"cls", "reg"}
    np.testing.assert_allclose(float(out["cls"]), np.mean((PREDS[0] > 0.5).astype(int) == TARGET[0]), atol=1e-6)
    _close(out, jout)
    _close(batch, jbatch)
    with pytest.raises(ValueError, match="same keys"):
        port.MultitaskWrapper({"a": port.SumMetric(device="cpu")}).update({"b": 1.0}, {"b": 1.0})


# ------------------------------------------------------------------ Running
def test_running_window_semantics(jax):
    def run(ns):
        w = ns.wrappers.Running(ns.aggregation.SumMetric(**ns.device), window=3)
        for v in [1.0, 2.0, 3.0, 4.0, 5.0]:
            w.update(_asarray(ns, np.asarray(v, np.float32)))
        return float(w.compute())

    assert both(jax, run) == (12.0, 12.0)


def test_running_empty_window_warns():
    w = port_wrappers.Running(port.SumMetric(device="cpu"), window=2)
    with pytest.warns(UserWarning, match="before the .*update"):
        w.compute()


def test_running_mean_window(jax):
    def run(ns):
        w = ns.wrappers.Running(ns.aggregation.MeanMetric(**ns.device), window=2)
        for v in [1.0, 5.0, 9.0]:
            w.update(_asarray(ns, np.asarray(v, np.float32)))
        return float(w.compute())

    assert both(jax, run) == (7.0, 7.0)


# ------------------------------------------------------------------ MetricTracker
def test_tracker_best_metric_and_steps(jax):
    def run(ns):
        tracker = ns.wrappers.MetricTracker(ns.classification.BinaryAccuracy(**ns.device), maximize=True)
        for epoch in range(3):
            tracker.increment()
            for i in range(NB):
                tracker.update(_asarray(ns, (PREDS[i] + NOISE[epoch, i] * epoch) % 1.0), _asarray(ns, TARGET[i]))
        return tracker.compute_all(), tracker.best_metric(return_step=True), tracker.n_steps

    (allv, (best, step), n), (jallv, jbest, jn) = both(jax, run)
    assert tuple(allv.shape) == (3,) and n == jn == 3
    assert step == int(np.argmax(allv.numpy())) == jbest[1]
    np.testing.assert_allclose(best, float(allv.max()), atol=1e-6)
    _close(allv, jallv)


def test_tracker_collection_tracking(jax):
    """``maximize`` per key: accuracy maximized, precision minimized."""
    def run(ns):
        col = ns.MetricCollection([ns.classification.MulticlassAccuracy(num_classes=C, **ns.device),
                                   ns.classification.MulticlassPrecision(num_classes=C, **ns.device)])
        tracker = ns.wrappers.MetricTracker(col, maximize=[True, False])
        for epoch in range(3):
            tracker.increment()
            tracker.update(_asarray(ns, MC_PREDS[epoch]), _asarray(ns, MC_TARGET[epoch]))
        return tracker.compute_all(), tracker.best_metric(return_step=True)

    (res, best), (jres, jbest) = both(jax, run)
    assert set(res) == {"MulticlassAccuracy", "MulticlassPrecision"}
    assert tuple(res["MulticlassAccuracy"].shape) == (3,)
    _close(res, jres)
    assert best[1] == jbest[1]
    np.testing.assert_allclose([best[0][k] for k in sorted(best[0])], [jbest[0][k] for k in sorted(jbest[0])], rtol=1e-6)
    assert best[1]["MulticlassPrecision"] == int(np.argmin(res["MulticlassPrecision"].numpy()))


def test_tracker_update_before_increment_raises(jax):
    for ns in (PORT, jax):
        tracker = ns.wrappers.MetricTracker(ns.classification.BinaryAccuracy(**ns.device))
        with pytest.raises(ValueError, match="increment"):
            tracker.update(_asarray(ns, PREDS[0]), _asarray(ns, TARGET[0]))
