"""State carried from the JAX package into the port with ``interop.load_numpy_state``, for each family
of the rest of classification: a JAX metric accumulates three batches, its ``metric_state`` goes
across as numpy arrays, and the port's ``compute()`` gives JAX's value (rtol=1e-6: the same states
go through the same float32 reduction). Float32 states stay float32, JAX's int32 confusion
matrices and float32 counts become the port's int64 counts.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu_torch.interop import load_numpy_state


def _multiclass(rng, n=50):
    return rng.randn(n, 4).astype(np.float32), rng.randint(0, 4, n)


def _multilabel(rng, n=50):
    return rng.rand(n, 4).astype(np.float32), rng.randint(0, 2, (n, 4))


def _binary(rng, n=50):
    return rng.rand(n).astype(np.float32), rng.randint(0, 2, n)


def _groups(rng, n=50):
    return rng.rand(n).astype(np.float32), rng.randint(0, 2, n), rng.randint(0, 3, n)


CASES = [
    ("MulticlassCohenKappa", {"num_classes": 4, "weights": "quadratic"}, _multiclass, torch.int64),
    ("MulticlassMatthewsCorrCoef", {"num_classes": 4}, _multiclass, torch.int64),
    ("MultilabelJaccardIndex", {"num_labels": 4}, _multilabel, torch.int64),
    ("MulticlassSpecificity", {"num_classes": 4}, _multiclass, torch.int64),
    ("BinaryHammingDistance", {"multidim_average": "global"}, _binary, torch.int64),
    ("Dice", {"num_classes": 4, "average": "macro"}, _multiclass, torch.float32),
    ("Dice", {"num_classes": 4, "average": "samples"}, _multiclass, torch.float32),
    ("MulticlassExactMatch", {"num_classes": 4}, _multiclass, torch.float32),
    ("MultilabelExactMatch", {"num_labels": 4, "multidim_average": "global"}, _multilabel, torch.float32),
    ("BinaryHingeLoss", {"squared": True}, _binary, torch.float32),
    ("MulticlassHingeLoss", {"num_classes": 4, "multiclass_mode": "one-vs-all"}, _multiclass, torch.float32),
    ("MultilabelRankingAveragePrecision", {"num_labels": 4}, _multilabel, torch.float32),
    ("MultilabelCoverageError", {"num_labels": 4}, _multilabel, torch.float32),
    ("BinaryGroupStatRates", {"num_groups": 3}, _groups, torch.float32),
    ("BinaryFairness", {"num_groups": 3}, _groups, torch.float32),
]


@pytest.mark.parametrize("name,kwargs,make,dtype", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_jax_state_loads_and_computes_the_same(name, kwargs, make, dtype):
    pytest.importorskip("jax")
    import torchmetrics_tpu.classification as jc

    rng = np.random.RandomState(len(name))
    theirs = getattr(jc, name)(**kwargs)
    for _ in range(3):
        theirs.update(*make(rng))
    arrays = {k: [np.asarray(e) for e in v] if isinstance(v, list) else np.asarray(v)
              for k, v in theirs.metric_state.items()}
    ours = load_numpy_state(getattr(tc, name)(device="cpu", **kwargs), arrays)
    for key, value in ours.metric_state.items():
        for entry in value if isinstance(value, list) else [value]:
            assert entry.dtype == dtype, key
    got, want = ours.compute(), theirs.compute()
    if isinstance(want, dict):
        assert list(got) == list(want)
        got, want = [got[k] for k in want], [want[k] for k in want]
    else:
        got, want = [got], [want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def _regression(rng, n=50, outputs=1):
    shape = (n,) if outputs == 1 else (n, outputs)
    preds = rng.randn(*shape).astype(np.float32)
    return preds, (preds + rng.randn(*shape) + 2.0).astype(np.float32)


REGRESSION_CASES = [
    ("PearsonCorrCoef", {}, 1),
    ("PearsonCorrCoef", {"num_outputs": 3}, 3),
    ("ConcordanceCorrCoef", {}, 1),
    ("R2Score", {"adjusted": 2}, 1),
    ("R2Score", {"num_outputs": 3, "multioutput": "variance_weighted"}, 3),
    ("RelativeSquaredError", {}, 1),
    ("SpearmanCorrCoef", {}, 1),
    ("SpearmanCorrCoef", {"num_outputs": 2}, 2),
    ("KendallRankCorrCoef", {"t_test": True}, 1),
]


@pytest.mark.parametrize("name,kwargs,outputs", REGRESSION_CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(REGRESSION_CASES)])
def test_jax_regression_state_loads_and_computes_the_same(name, kwargs, outputs):
    """float32 sums and moments stay float32, ``cat`` entries load as lists; rtol 1e-5, as the
    regression computes hold to the JAX package."""
    pytest.importorskip("jax")
    import torchmetrics_tpu.regression as jr

    import torchmetrics_tpu_torch.regression as tr

    rng = np.random.RandomState(len(name) + outputs)
    theirs = jr.__dict__[name](**kwargs)
    for _ in range(3):
        theirs.update(*_regression(rng, outputs=outputs))
    arrays = {k: [np.asarray(e) for e in v] if isinstance(v, list) else np.asarray(v)
              for k, v in theirs.metric_state.items()}
    ours = load_numpy_state(getattr(tr, name)(device="cpu", **kwargs), arrays)
    for key, value in ours.metric_state.items():
        assert isinstance(value, list) == isinstance(arrays[key], list), key
        for entry in value if isinstance(value, list) else [value]:
            assert entry.dtype == torch.float32, key
    got, want = ours.compute(), theirs.compute()
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("outputs", [1, 3])
def test_pearson_states_with_a_world_axis(outputs):
    """Pearson's six states stacked over three replicas (as sync hands them) keep their leading world
    axis when loaded, and the compute folds it with ``_final_aggregation``: the JAX package's value."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import torchmetrics_tpu.regression as jr

    import torchmetrics_tpu_torch.regression as tr

    rng = np.random.RandomState(outputs)
    kwargs = {} if outputs == 1 else {"num_outputs": outputs}
    replicas = []
    for _ in range(3):
        m = jr.PearsonCorrCoef(**kwargs)
        for _ in range(2):
            m.update(*_regression(rng, outputs=outputs))
        replicas.append({k: np.asarray(v) for k, v in m.metric_state.items()})
    stacked = {k: np.stack([r[k] for r in replicas]) for k in replicas[0]}
    ours = load_numpy_state(tr.PearsonCorrCoef(device="cpu", **kwargs), stacked)
    assert ours.metric_state["n_total"].shape == (3,)
    assert ours.metric_state["mean_x"].shape == ((3,) if outputs == 1 else (3, outputs))
    theirs = jr.PearsonCorrCoef(**kwargs)
    want = theirs._compute({k: jnp.asarray(v) for k, v in stacked.items()})
    np.testing.assert_allclose(ours.compute().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_synced_pearson_state_from_the_jax_package():
    """JAX's replica 0 synced over a world of two (``sync`` without ``unsync``): its states carry
    the world axis, load as they are, and give JAX's synced value."""
    pytest.importorskip("jax")
    import torchmetrics_tpu.regression as jr

    import torchmetrics_tpu_torch.regression as tr

    rng = np.random.RandomState(37)
    replicas = [jr.PearsonCorrCoef() for _ in range(2)]
    for m, n in zip(replicas, (37, 63)):
        m.update(*_regression(rng, n=n))
    states = [r._state.snapshot() for r in replicas]
    replicas[0].sync(dist_sync_fn=lambda v, g=None, name=None: [s[name] for s in states], distributed_available=lambda: True)
    arrays = {k: np.asarray(v) for k, v in replicas[0].metric_state.items()}
    assert arrays["n_total"].shape == (2,)
    want = replicas[0]._compute(replicas[0]._computable_state())
    ours = load_numpy_state(tr.PearsonCorrCoef(device="cpu"), arrays)
    np.testing.assert_allclose(ours.compute().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _wrapper_pair(name):
    import torchmetrics_tpu.aggregation as ja
    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu.regression as jr
    import torchmetrics_tpu.wrappers as jw

    import torchmetrics_tpu_torch.aggregation as ta
    import torchmetrics_tpu_torch.regression as tr
    import torchmetrics_tpu_torch.wrappers as tw

    if name == "BootStrapper":
        return (jw.BootStrapper(jc.BinaryAccuracy(), num_bootstraps=4, seed=3, raw=True),
                tw.BootStrapper(tc.BinaryAccuracy(device="cpu"), num_bootstraps=4, seed=3, raw=True))
    if name == "MultioutputWrapper":
        return (jw.MultioutputWrapper(jr.MeanSquaredError(), num_outputs=3),
                tw.MultioutputWrapper(tr.MeanSquaredError(device="cpu"), num_outputs=3))
    if name == "ClasswiseWrapper":
        return (jw.ClasswiseWrapper(jc.MulticlassAccuracy(num_classes=4, average=None)),
                tw.ClasswiseWrapper(tc.MulticlassAccuracy(num_classes=4, average=None, device="cpu")))
    return jw.MinMaxMetric(ja.MeanMetric()), tw.MinMaxMetric(ta.MeanMetric(device="cpu"))


def _state(m):
    return {k: [np.asarray(e) for e in v] if isinstance(v, list) else np.asarray(v) for k, v in m.metric_state.items()}


@pytest.mark.parametrize("name", ["BootStrapper", "MultioutputWrapper", "ClasswiseWrapper", "MinMaxMetric"])
def test_wrapper_states_load(name):
    """Each wrapped copy's state, and ``MinMaxMetric``'s running extremes, carried across under the
    JAX package's attribute names; the port's ``compute()`` gives JAX's value."""
    pytest.importorskip("jax")
    theirs, ours = _wrapper_pair(name)
    rng = np.random.RandomState(len(name))
    for step in range(3):
        if name == "BootStrapper":
            theirs.update(*_binary(rng))
        elif name == "MultioutputWrapper":
            theirs.update(*_regression(rng, outputs=3))
        elif name == "ClasswiseWrapper":
            theirs.update(*_multiclass(rng))
        else:
            theirs.update(rng.rand(10).astype(np.float32))
            theirs.compute()  # moves the running extremes
    if name in ("BootStrapper", "MultioutputWrapper"):
        arrays = {"metrics": [_state(m) for m in theirs.metrics]}
    elif name == "ClasswiseWrapper":
        arrays = {"metric": _state(theirs.metric)}
    else:
        arrays = {"_base_metric": _state(theirs._base_metric), "min_val": np.asarray(theirs.min_val),
                  "max_val": np.asarray(theirs.max_val)}
    load_numpy_state(ours, arrays)
    got, want = ours.compute(), theirs.compute()
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        got, want = [got[k] for k in sorted(want)], [want[k] for k in sorted(want)]
    else:
        got, want = [got], [want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    with pytest.raises(KeyError, match="takes no state"):
        load_numpy_state(ours, {"unknown": np.zeros(1)})
