"""The sketch specs and the two streaming metrics of the port against the JAX package.

The same numpy inputs, made from a seed, go through ``torchmetrics_tpu.sketch`` and
``torchmetrics_tpu_torch.sketch``: the exports, the specs and wire kinds, the engine's sketch counters, the metrics'
checks, and ``StreamingQuantile`` and ``StreamingHistogram`` through ``update``, ``forward``, ``update_batches``
and ``compute`` on the eager tier and the emulated graph tier. The count-min and KLL tests are in
``tests/test_torch_countmin.py`` and ``tests/test_torch_kll.py``.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.sketch as ps
from torchmetrics_tpu_torch.ops import dispatch
from torchmetrics_tpu_torch.sketch import kll as pk


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import jax as jax_mod
    import jax.numpy as jnp

    import torchmetrics_tpu.sketch as js
    from torchmetrics_tpu.sketch import countmin, kll, state

    return SimpleNamespace(jnp=jnp, jit=jax_mod.jit, sketch=js, cm=countmin, kll=kll, state=state)


def _bits(x) -> bytes:
    return (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).tobytes()


def _on_tier(tier: str, monkeypatch) -> None:
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", tier == "graph")
    if tier == "eager":
        monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
    else:
        monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)


def test_exports_are_jax_s(jax):
    assert sorted(ps.__all__) == sorted(jax.sketch.__all__) and len(ps.__all__) == 31
    for name in ps.__all__:
        assert hasattr(ps, name), name


# ------------------------------------------------------------------ specs
def test_specs_and_wire_kinds_as_jax(jax):
    for ours, theirs in ((ps.kll_spec(64, 12), jax.state.kll_spec(64, 12)), (ps.countmin_spec(2, 300), jax.state.countmin_spec(2, 300))):
        assert ours.describe() == theirs.describe() and ours.state_bytes() == theirs.state_bytes()
        assert _bits(ours.init()) == _bits(theirs.init())
    assert ps.kll_spec().reduce_fx is pk.kll_merge_stacked and ps.countmin_spec().reduce_fx == "sum"
    assert ps.SKETCH_EQUIVALENTS == jax.state.SKETCH_EQUIVALENTS
    ours, theirs = ps.StreamingQuantile(device="cpu"), jax.sketch.StreamingQuantile()
    assert ps.sketch_wire_kinds(ours) == jax.state.sketch_wire_kinds(theirs) == {"sketch": "kll"}
    assert ps.sketch_descriptor(ours) == jax.state.sketch_descriptor(theirs)
    assert ps.sketch_state_bytes(ours) == jax.state.sketch_state_bytes(theirs)
    assert ps.sketch_wire_kinds(ps.StreamingHistogram(device="cpu")) == {"hist": "hist"}
    with pytest.raises(NotImplementedError, match="item 9"):
        ps.sketch_wire_bytes(ours)
    assert ps.note_update(ours, (), {}) is None and jax.state.note_update(theirs, (), {}) is None


def _counter_deltas(registry, names, fn):
    before = {n: registry.counter(n).value for n in names}
    fn()
    return {n: registry.counter(n).value - before[n] for n in names}


SKETCH_COUNTERS = ("sketch.merges", "sketch.compactions", "sketch.state_bytes_saved", "sketch.states_registered")


@pytest.mark.parametrize("case", ["quantile-update", "quantile-batches", "quantile-forward", "histogram", "auroc-sketch",
                                  "quantile-small-and-empty"])
def test_note_update_counters_as_jax(jax, case):
    """The engine's sketch counters (``note_update`` after each update, ``sketch.states_registered`` at
    construction) move by JAX's amounts for the same calls on the same numpy inputs."""
    from torchmetrics_tpu import obs as jobs
    from torchmetrics_tpu.classification import BinaryAUROC as JBinaryAUROC

    from torchmetrics_tpu_torch import obs as pobs
    from torchmetrics_tpu_torch.classification import BinaryAUROC as PBinaryAUROC

    rng = np.random.RandomState(11)
    values = rng.normal(0, 1, (3, 700)).astype(np.float32)
    scores, labels = rng.uniform(0, 1, 500).astype(np.float32), rng.randint(0, 2, 500).astype(np.int32)

    def drive(ns, sk, auroc, device):
        if case == "quantile-update":
            m = sk.StreamingQuantile(q=0.5, capacity=64, levels=10, **device)
            for v in values:
                m.update(v)
        elif case == "quantile-batches":
            sk.StreamingQuantile(q=0.5, capacity=32, **device).update_batches(values)
        elif case == "quantile-forward":
            m = sk.StreamingQuantile(q=(0.1, 0.9), **device)
            for v in values:
                m(v)
        elif case == "histogram":
            sk.StreamingHistogram(bins=16, **device).update(values[0])
        elif case == "auroc-sketch":
            auroc(approx="sketch", sketch_bins=64, **device).update(scores, labels)
        else:  # a batch below capacity (no compaction), then an empty one (no bytes)
            m = sk.StreamingQuantile(capacity=128, **device)
            m.update(values[0, :100])
            m.update(values[0, :0])

    ours = _counter_deltas(pobs.telemetry, SKETCH_COUNTERS, lambda: drive(None, ps, PBinaryAUROC, {"device": "cpu"}))
    theirs = _counter_deltas(jobs.telemetry, SKETCH_COUNTERS, lambda: drive(None, jax.sketch, JBinaryAUROC, {}))
    assert ours == theirs and ours["sketch.merges"] > 0


@pytest.mark.parametrize("cls, kwargs", [
    ("StreamingQuantile", {"q": 1.5}), ("StreamingQuantile", {"q": ()}), ("StreamingQuantile", {"q": (0.5, -0.1)}),
    ("StreamingQuantile", {"capacity": 7}), ("StreamingHistogram", {"lo": 1.0, "hi": 1.0}),
    ("StreamingHistogram", {"bins": 1}),
])
def test_metric_checks_raise_as_jax(jax, cls, kwargs):
    with pytest.raises(ValueError):
        getattr(jax.sketch, cls)(**kwargs)
    with pytest.raises(ValueError):
        getattr(ps, cls)(device="cpu", **kwargs)


# ------------------------------------------------------------------ the streaming metrics
STREAMING = {
    "StreamingQuantile": ({"q": (0.1, 0.5, 0.99), "capacity": 32, "levels": 12}, "sketch"),
    "StreamingQuantile-scalar": ({"q": 0.9}, "sketch"),
    "StreamingHistogram": ({"bins": 16, "lo": -2.0, "hi": 3.0}, "hist"),
}


@pytest.mark.parametrize("tier", ["graph", "eager"])
@pytest.mark.parametrize("case", sorted(STREAMING))
def test_streaming_metrics_equal_jax_s(jax, monkeypatch, case, tier):
    """``forward`` twice, ``update`` twice and ``update_batches`` of three: every batch value and the
    state equal to the JAX package's (the KLL state bit for bit), then ``compute``."""
    _on_tier(tier, monkeypatch)
    kwargs, state = STREAMING[case]
    name = case.split("-")[0]
    ours, theirs = getattr(ps, name)(device="cpu", **kwargs), getattr(jax.sketch, name)(**kwargs)
    rng = np.random.RandomState(len(case))
    batches = rng.normal(0.5, 1.5, (7, 300)).astype(np.float32)
    batches[3, :4] = (np.inf, -np.inf, 9.0, -9.0)
    for b in batches[:2]:
        assert _bits(ours(torch.from_numpy(b))) == _bits(theirs(jax.jnp.asarray(b)))
    for b in batches[2:4]:
        ours.update(torch.from_numpy(b))
        theirs.update(jax.jnp.asarray(b))
    ours.update_batches(torch.from_numpy(batches[4:]))
    theirs.update_batches(jax.jnp.asarray(batches[4:]))
    assert _bits(ours.metric_state[state]) == _bits(theirs.metric_state[state])
    assert _bits(ours.compute()) == _bits(theirs.compute())
    if name == "StreamingQuantile":
        assert float(ours.total_count) == float(theirs.total_count) == batches.size
    else:
        np.testing.assert_array_equal(ours.edges, theirs.edges)
    if tier == "graph":
        assert ours._graphs.state is not None  # the forward, update and update_batches ran as graphs
