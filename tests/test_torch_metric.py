"""The core lifecycle of the PyTorch port's ``Metric`` (``update``, reduce-state ``forward``,
``compute`` with its cache, ``reset``, ``state_dict``, ``to``) against the JAX package's ``Metric``.

One metric with a state of each reduction (sum, mean, max, min, cat) goes through the same numpy
batches in both packages. The values are float32 sums of a few small numbers: rtol=1e-6.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.metric import Metric as JaxMetric
from torchmetrics_tpu_torch.classification import MulticlassStatScores
from torchmetrics_tpu_torch.metric import Metric


class JaxEveryReduction(JaxMetric):
    def __init__(self):
        super().__init__()
        self.add_state("s", jnp.zeros((), jnp.float32), dist_reduce_fx="sum")
        self.add_state("m", jnp.zeros((), jnp.float32), dist_reduce_fx="mean")
        self.add_state("hi", jnp.asarray(-jnp.inf, jnp.float32), dist_reduce_fx="max")
        self.add_state("lo", jnp.asarray(jnp.inf, jnp.float32), dist_reduce_fx="min")
        self.add_state("seen", [], dist_reduce_fx="cat")

    def _update(self, state, x):
        return {"s": state["s"] + jnp.sum(x), "m": jnp.mean(x), "hi": jnp.maximum(state["hi"], jnp.max(x)),
                "lo": jnp.minimum(state["lo"], jnp.min(x)), "seen": x}

    def _compute(self, state):
        return jnp.stack([state["s"], state["m"], state["hi"], state["lo"], jnp.sum(state["seen"])])


class TorchEveryReduction(Metric):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("s", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum", persistent=True)
        self.add_state("m", torch.zeros((), dtype=torch.float32), dist_reduce_fx="mean", persistent=True)
        self.add_state("hi", torch.tensor(-np.inf, dtype=torch.float32), dist_reduce_fx="max", persistent=True)
        self.add_state("lo", torch.tensor(np.inf, dtype=torch.float32), dist_reduce_fx="min", persistent=True)
        self.add_state("seen", [], dist_reduce_fx="cat", persistent=True)

    def _update(self, state, x):
        return {"s": state["s"] + torch.sum(x), "m": torch.mean(x), "hi": torch.maximum(state["hi"], torch.max(x)),
                "lo": torch.minimum(state["lo"], torch.min(x)), "seen": x}

    def _compute(self, state):
        return torch.stack([state["s"], state["m"], state["hi"], state["lo"], torch.sum(state["seen"])])


def _batches(n: int = 5):
    rng = np.random.RandomState(0)
    return [rng.randn(rng.randint(3, 9)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("call", ["forward", "update"])
def test_lifecycle_matches_jax(call):
    ours, theirs = TorchEveryReduction(device="cpu"), JaxEveryReduction()
    for x in _batches():
        a, b = getattr(ours, call)(x), getattr(theirs, call)(jnp.asarray(x))
        if call == "forward":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        np.testing.assert_allclose(ours.compute().numpy(), np.asarray(theirs.compute()), rtol=1e-6)
    assert ours.update_count == theirs.update_count == 5
    ours.reset()
    theirs.reset()
    assert ours.update_count == 0 and not ours.update_called
    assert ours.metric_state["seen"] == [] and float(ours.metric_state["hi"]) == -np.inf


def test_compute_is_cached_until_the_next_update():
    m = TorchEveryReduction(device="cpu")
    m.update(np.ones(3, np.float32))
    first = m.compute()
    assert m.compute() is first
    m.update(np.ones(2, np.float32))
    assert m.compute() is not first and float(m.compute()[0]) == 5.0


def test_compute_before_update_warns():
    with pytest.warns(UserWarning, match="before the ``update``"):
        MulticlassStatScores(num_classes=3, device="cpu").compute()


def test_state_dict_round_trip_and_to():
    src = TorchEveryReduction(device="cpu")
    for x in _batches(3):
        src(x)
    sd = src.state_dict()
    assert sd["_update_count"] == 3 and len(sd["seen"]) == 3
    dst = TorchEveryReduction(device="cpu")
    dst.load_state_dict(sd)
    assert dst.update_count == 3
    torch.testing.assert_close(dst.compute(), src.compute(), rtol=0, atol=0)
    x = _batches(4)[-1]
    torch.testing.assert_close(dst(x), src(x), rtol=0, atol=0)
    torch.testing.assert_close(dst.compute(), src.compute(), rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="Missing key"):
        TorchEveryReduction(device="cpu").load_state_dict({"s": torch.tensor(1.0)})
    moved = dst.to("cpu")
    assert moved is dst and dst.device == torch.device("cpu")


def test_add_state_rejects_unknown_reduction():
    m = Metric(device="cpu")
    with pytest.raises(ValueError, match="dist_reduce_fx"):
        m.add_state("x", torch.zeros(()), dist_reduce_fx="median")
    with pytest.raises(ValueError, match="empty list"):
        m.add_state("y", [torch.zeros(())])


@pytest.mark.parametrize("how", ["clone", "deepcopy", "pickle"])
def test_copies_round_trip_and_stay_independent(how):
    import copy
    import pickle

    src = TorchEveryReduction(device="cpu")
    for x in _batches(3):
        src(x)
    dup = {"clone": lambda m: m.clone(), "deepcopy": copy.deepcopy, "pickle": lambda m: pickle.loads(pickle.dumps(m))}[how](src)
    assert dup is not src and dup.update_count == 3 and not dup._graphs.steps
    torch.testing.assert_close(dup.compute(), src.compute(), rtol=0, atol=0)
    x = _batches(4)[-1]
    dup(x)
    assert src.update_count == 3 and dup.update_count == 4
    assert len(src.metric_state["seen"]) == 3 and len(dup.metric_state["seen"]) == 4
    src(x)
    torch.testing.assert_close(dup.compute(), src.compute(), rtol=0, atol=0)


class JaxFullState(JaxMetric):
    full_state_update = True

    def __init__(self, with_list: bool):
        super().__init__()
        self.add_state("hi", jnp.asarray(-jnp.inf, jnp.float32), dist_reduce_fx="max")
        self.add_state("n", jnp.zeros((), jnp.float32), dist_reduce_fx="sum")
        if with_list:
            self.add_state("seen", [], dist_reduce_fx="cat")

    def _update(self, state, x):
        out = {"hi": jnp.maximum(state["hi"], jnp.max(x)), "n": state["n"] + x.shape[0]}
        return {**out, "seen": x} if "seen" in self._defaults else out

    def _compute(self, state):
        return state["hi"] * state["n"]


class TorchFullState(Metric):
    full_state_update = True

    def __init__(self, with_list: bool, **kwargs):
        super().__init__(**kwargs)
        self.add_state("hi", torch.tensor(-np.inf, dtype=torch.float32), dist_reduce_fx="max")
        self.add_state("n", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        if with_list:
            self.add_state("seen", [], dist_reduce_fx="cat")

    def _update(self, state, x):
        out = {"hi": torch.maximum(state["hi"], torch.max(x)), "n": state["n"] + x.shape[0]}
        return {**out, "seen": x} if "seen" in self._defaults else out

    def _compute(self, state):
        return state["hi"] * state["n"]


@pytest.mark.parametrize("with_list", [False, True], ids=["batch-value", "reset-update-restore"])
def test_full_state_update_forward_matches_jax(with_list):
    ours, theirs = TorchFullState(with_list, device="cpu"), JaxFullState(with_list)
    for x in _batches():
        np.testing.assert_allclose(ours(x).numpy(), np.asarray(theirs(jnp.asarray(x))), rtol=1e-6)
        np.testing.assert_allclose(ours.compute().numpy(), np.asarray(theirs.compute()), rtol=1e-6)
    assert ours.update_count == theirs.update_count == 5
    if with_list:
        assert len(ours.metric_state["seen"]) == 5


def test_set_dtype_matches_jax():
    """``set_dtype`` casts the float states, their defaults and float list entries, as the JAX
    package does (float16: JAX's 64-bit mode is off, so a float64 cast would be float32 there)."""
    ours, theirs = TorchEveryReduction(device="cpu"), JaxEveryReduction()
    batches = _batches(6)
    for x in batches[:3]:
        ours.update(x)
        theirs.update(jnp.asarray(x))
    assert ours.set_dtype(torch.float16) is ours
    theirs.set_dtype(jnp.float16)
    for name in ("s", "m", "hi", "lo"):
        assert ours.metric_state[name].dtype == torch.float16 == torch.from_numpy(np.asarray(theirs.metric_state[name])).dtype
        assert ours._defaults[name].dtype == torch.float16
        np.testing.assert_array_equal(ours.metric_state[name].numpy(), np.asarray(theirs.metric_state[name]))
    assert all(e.dtype == torch.float16 for e in ours.metric_state["seen"])
    for x in batches[3:]:
        np.testing.assert_allclose(ours(x).numpy(), np.asarray(theirs(jnp.asarray(x))), rtol=2e-3)
    np.testing.assert_allclose(ours.compute().numpy(), np.asarray(theirs.compute()), rtol=2e-3)
    for name in ("s", "m", "hi", "lo"):
        assert ours.metric_state[name].dtype == torch.from_numpy(np.asarray(theirs.metric_state[name])).dtype


def test_float_double_half_are_no_ops():
    m = TorchEveryReduction(device="cpu")
    m.update(np.ones(2, np.float32))
    for cast in (m.float, m.double, m.half):
        assert cast() is m
        assert m.metric_state["s"].dtype == torch.float32 and m._defaults["s"].dtype == torch.float32


@pytest.mark.parametrize("step", ["forward", "update"])
def test_set_dtype_drops_the_graphs_and_captures_anew(step, monkeypatch):
    """On the graph tier the graphs read buffers of the old dtype: after ``set_dtype`` the next
    step captures a new graph (one capture, no fallback) and never replays an old one, and the
    values equal an eager run in the new dtype."""
    from torchmetrics_tpu_torch.aggregation import MeanMetric
    from torchmetrics_tpu_torch.ops import dispatch

    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)
    rng = np.random.RandomState(1)
    batches = [torch.from_numpy(rng.randn(40).astype(np.float32)) for _ in range(6)]

    def run(eager: bool):
        m = MeanMetric(device="cpu")
        m.fast_update = True
        values = []
        for i, x in enumerate(batches):
            if i == 3:
                m.set_dtype(torch.float64)
                assert m._graphs.state is None and m._graphs.count is None and not m._graphs.steps
                dispatch.STATS.reset()
            if eager:
                monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
            out = getattr(m, step)(x)
            monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)
            if step == "forward":
                values.append(out)
            if i == 3 and not eager:
                assert (dispatch.STATS.captures, dispatch.STATS.replays, dispatch.STATS.n_fallbacks) == (1, 1, 0)
                assert m._graphs.state["mean_value"].dtype == torch.float64
        return values, m.compute(), m.metric_state

    graph_values, graph_total, graph_state = run(eager=False)
    eager_values, eager_total, eager_state = run(eager=True)
    assert graph_total.dtype == torch.float64 and torch.equal(graph_total, eager_total)
    assert all(torch.equal(a, b) for a, b in zip(graph_values, eager_values))
    assert all(torch.equal(graph_state[k], eager_state[k]) and graph_state[k].dtype == torch.float64 for k in graph_state)


# ------------------------------------------------------------------ persistent and dtype (queue C, C2)
def test_persistent_and_dtype_match_jax():
    import torchmetrics_tpu.classification as jc
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy

    preds, target = np.array([0, 1, 2, 2]), np.array([0, 1, 1, 2])
    ours, theirs = MulticlassAccuracy(3, device="cpu"), jc.MulticlassAccuracy(3)
    for m in (ours, theirs):
        m.update(preds, target)
    assert ours.state_dict() == {} and theirs.state_dict() == {}
    ours.persistent(True)
    theirs.persistent(True)
    assert sorted(ours.state_dict()) == sorted(theirs.state_dict()) == ["_update_count", "fn", "fp", "tn", "tp"]
    for key, value in theirs.state_dict().items():
        np.testing.assert_array_equal(np.asarray(ours.state_dict()[key]), np.asarray(value))
    ours.persistent()
    assert ours.state_dict() == {}  # the JAX package's default mode is False
    ours_sum, theirs_sum = ours + ours, theirs + theirs
    ours_sum.persistent(True)
    theirs_sum.persistent(True)
    assert sorted(ours.state_dict()) == sorted(theirs.state_dict())
    assert ours_sum.state_dict() == {} and theirs_sum.state_dict() == {}  # the composition holds no state
    assert ours.dtype == torch.float32 and str(theirs.dtype).endswith("float32'>")
    ours.set_dtype(torch.float64)
    assert ours.dtype == torch.float64 and ours_sum.dtype == torch.float32
