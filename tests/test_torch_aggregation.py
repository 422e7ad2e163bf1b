"""The aggregation metrics of the PyTorch port against the JAX package's (``aggregation.py:28-272``),
on the same numpy batches from a seed: every class, every NaN strategy, ``weight``,
``empty_result`` and the ``Running`` window, through ``forward`` and ``update``.

Values match within rtol 1e-5 (the summation orders differ); NaN and inf handling must agree
exactly, including the fill that maps +-inf to the largest finite float32 values as
``jnp.nan_to_num`` does. ``'error'`` raises and ``'warn'`` warns in both packages.
"""
from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.aggregation as ja
import torchmetrics_tpu_torch.aggregation as ta
from torchmetrics_tpu_torch.ops import dispatch

CLASSES = ("MaxMetric", "MinMetric", "SumMetric", "MeanMetric", "CatMetric")
STRATEGIES = ("warn", "ignore", 2.5)


def _batches(seed: int = 0, special: bool = True):
    rng = np.random.RandomState(seed)
    out = [rng.randn(8).astype(np.float32) for _ in range(5)]  # one shape: JAX compiles each kernel once
    if special:
        out[1][0], out[3][2], out[4][1] = np.nan, np.inf, -np.inf
    return out


def _close(ours, theirs) -> None:
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, equal_nan=True)


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graph"])
@pytest.mark.parametrize("call", ["forward", "update"])
@pytest.mark.parametrize("strategy", STRATEGIES, ids=str)
@pytest.mark.parametrize("name", CLASSES)
def test_aggregators_match_jax(monkeypatch, name, strategy, call, graph):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", graph)
    ours, theirs = getattr(ta, name)(nan_strategy=strategy, device="cpu"), getattr(ja, name)(nan_strategy=strategy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # 'warn' warns in both; test_error_and_warn_strategies checks it
        for x in _batches():
            a, b = getattr(ours, call)(torch.from_numpy(x)), getattr(theirs, call)(jnp.asarray(x))
            if call == "forward":
                _close(a, b)
            _close(ours.compute(), theirs.compute())
    assert ours.update_count == theirs.update_count == 5


@pytest.mark.parametrize("strategy", ("ignore", 0.5))
def test_mean_metric_weights_match_jax(strategy):
    rng = np.random.RandomState(2)
    ours, theirs = ta.MeanMetric(nan_strategy=strategy, device="cpu"), ja.MeanMetric(nan_strategy=strategy)
    for i in range(4):
        value = rng.randn(6).astype(np.float32)
        weight = rng.rand(6).astype(np.float32)
        value[i], weight[(i + 2) % 6] = np.nan, np.nan
        _close(ours(torch.from_numpy(value), weight=torch.from_numpy(weight)), theirs(jnp.asarray(value), weight=jnp.asarray(weight)))
    ours.update(1.0, weight=3.0)  # scalars, and a scalar weight broadcast over the value
    theirs.update(1.0, weight=3.0)
    _close(ours.compute(), theirs.compute())


@pytest.mark.parametrize("empty_result", [0.0, float("nan")], ids=["zero", "nan"])
def test_mean_metric_empty_result(empty_result):
    ours, theirs = ta.MeanMetric(empty_result=empty_result, device="cpu"), ja.MeanMetric(empty_result=empty_result)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _close(ours.compute(), theirs.compute())
        all_nan = np.full(3, np.nan, np.float32)
        ours.reset()
        theirs.reset()
        ours.update(torch.from_numpy(all_nan))  # every input masked away: zero total weight
        theirs.update(jnp.asarray(all_nan))
        _close(ours.compute(), theirs.compute())
    with pytest.raises(ValueError, match="empty_result"):
        ta.MeanMetric(empty_result="zero", device="cpu")


@pytest.mark.parametrize("name", CLASSES)
def test_error_and_warn_strategies(name):
    x = np.array([1.0, np.nan], np.float32)
    with pytest.raises(RuntimeError, match="Encountered `nan` values"):
        getattr(ja, name)(nan_strategy="error").update(jnp.asarray(x))
    with pytest.raises(RuntimeError, match="Encountered `nan` values"):
        getattr(ta, name)(nan_strategy="error", device="cpu").update(torch.from_numpy(x))
    with pytest.warns(UserWarning, match="Will be removed"):
        getattr(ta, name)(nan_strategy="warn", device="cpu").update(torch.from_numpy(x))
    with pytest.raises(ValueError, match="nan_strategy"):
        getattr(ta, name)(nan_strategy="drop", device="cpu")


def test_max_min_of_empty_updates_and_cat_of_nothing():
    for name in ("MaxMetric", "MinMetric"):
        ours, theirs = getattr(ta, name)(device="cpu"), getattr(ja, name)()
        ours.update(torch.ones(0))
        theirs.update(jnp.ones(0))
        _close(ours.compute(), theirs.compute())
    cat = ta.CatMetric(device="cpu")
    with pytest.warns(UserWarning, match="before the ``update``"):
        assert cat.compute().shape == (0,)


@pytest.mark.parametrize("call", ["forward", "update"])
@pytest.mark.parametrize("window", [1, 2, 3, 7])
@pytest.mark.parametrize("name", ["RunningMean", "RunningSum"])
def test_running_window_matches_jax(name, window, call):
    ours, theirs = getattr(ta, name)(window=window, nan_strategy="ignore", device="cpu"), \
        getattr(ja, name)(window=window, nan_strategy="ignore")
    for x in _batches(seed=window, special=False):
        a, b = getattr(ours, call)(torch.from_numpy(x)), getattr(theirs, call)(jnp.asarray(x))
        if call == "forward":
            _close(a, b)
        _close(ours.compute(), theirs.compute())
    ours.reset()
    theirs.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _close(ours.compute(), theirs.compute())


def test_running_rejects_bad_arguments():
    from torchmetrics_tpu_torch.wrappers import Running

    with pytest.raises(ValueError, match="instance of"):
        Running(object())
    with pytest.raises(ValueError, match="positive integer"):
        Running(ta.SumMetric(device="cpu"), window=0)
    with pytest.raises(ValueError, match="full_state_update"):
        Running(ta.MaxMetric(device="cpu"))
