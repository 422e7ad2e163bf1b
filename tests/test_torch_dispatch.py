"""The dispatch tiers of the PyTorch port: a fused step as a captured CUDA graph, and the eager tier.

Each test drives the same metric through the same batches twice, once on the graph tier and once
on the eager tier (``TM_TPU_FAST_DISPATCH=0``), and holds the two to bit-identical batch values
and state (``test_fast_dispatch.py:80-148`` pins the same for the JAX package's tiers). The
``cpu`` cases run the graph tier's bookkeeping on the CPU (``dispatch.EMULATE_ON_CPU``: static
buffers written in place, copied outputs, the body called on each replay); the ``cuda`` cases
capture and replay real graphs, with the kernels K1, K2 and K3 inside them, and skip without a
card. On the card:

    python -m pytest --noconftest tests/test_torch_dispatch.py -m cuda

The test file imports no JAX, so it runs where JAX is not installed.
"""
from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.aggregation import MaxMetric, MeanMetric, SumMetric
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.ops import bincount as k1
from torchmetrics_tpu_torch.ops import curve_counts as k3
from torchmetrics_tpu_torch.ops import dispatch
from torchmetrics_tpu_torch.ops import hist_pair as k2
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


class EveryReduction(Metric):
    """A state of each fusable reduction: sum, mean, max, min."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("s", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum", persistent=True)
        self.add_state("m", torch.zeros(3, dtype=torch.float32), dist_reduce_fx="mean", persistent=True)
        self.add_state("hi", torch.tensor(-np.inf, dtype=torch.float32), dist_reduce_fx="max", persistent=True)
        self.add_state("lo", torch.tensor(np.inf, dtype=torch.float32), dist_reduce_fx="min", persistent=True)

    def _update(self, state, x):
        return {"s": state["s"] + torch.sum(x), "m": x[:3] * 0.5 + x[-3:], "hi": torch.maximum(state["hi"], torch.max(x)),
                "lo": torch.minimum(state["lo"], torch.min(x))}

    def _compute(self, state):
        return torch.cat([state["s"][None], state["m"], state["hi"][None], state["lo"][None]])


@pytest.fixture
def device(request, monkeypatch):
    name = request.param
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph tier captures CUDA graphs")
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    dispatch.STATS.reset()
    return torch.device(name, 0) if name == "cuda" else torch.device("cpu")


def _eager(monkeypatch):
    monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")


def _graph(monkeypatch):
    monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)


def _batches(device, n=8, size=33, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(size).astype(np.float32)).to(device) for _ in range(n)]


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def _drive(monkeypatch, tier, make, steps):
    """``steps(metric)`` on a fresh metric on one tier; returns its result and the metric."""
    (_graph if tier == "graph" else _eager)(monkeypatch)
    metric = make()
    return steps(metric), metric


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_forward_tiers_bit_identical(device, monkeypatch):
    batches = _batches(device)

    def steps(m):
        return [m(x) for x in batches], m.metric_state, m.compute()

    graph, gm = _drive(monkeypatch, "graph", lambda: EveryReduction(device=device), steps)
    eager, _ = _drive(monkeypatch, "eager", lambda: EveryReduction(device=device), steps)
    assert _equal(graph, eager)
    assert dispatch.STATS.captures == 1 and dispatch.STATS.replays == len(batches)
    assert gm.state_generation == len(batches) and gm.update_count == len(batches)
    # the mean state merged over eight steps: ((n - 1) * m + batch) / n with n fed from the device
    want = torch.stack([x[:3] * 0.5 + x[-3:] for x in batches]).mean(0)
    torch.testing.assert_close(graph[1]["m"], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_shape_change_recaptures(device, monkeypatch):
    batches = _batches(device, n=3, size=33) + _batches(device, n=3, size=17, seed=1) + _batches(device, n=2, size=33, seed=2)

    def steps(m):
        return [m(x) for x in batches], m.metric_state

    graph, gm = _drive(monkeypatch, "graph", lambda: EveryReduction(device=device), steps)
    eager, _ = _drive(monkeypatch, "eager", lambda: EveryReduction(device=device), steps)
    assert _equal(graph, eager)
    assert dispatch.STATS.captures == 2 and dispatch.STATS.replays == len(batches)
    assert len(gm._graphs.steps) == 2


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_held_values_do_not_change(device, monkeypatch):
    _graph(monkeypatch)
    m = EveryReduction(device=device)
    held = []
    for x in _batches(device):
        value = m(x)
        snapshot = (value, m.metric_state, m.state_dict(), m.compute())
        held.append((snapshot, tuple(_clone(s) for s in snapshot)))
    for snapshot, copy in held:
        assert _equal(snapshot, copy)
    assert len({float(s[0][0][0]) for s in held}) == len(held)  # the batch values differ step to step


def _clone(x):
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x.clone() if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_clone_and_pickle_of_a_captured_metric_stay_independent(device, monkeypatch):
    _graph(monkeypatch)
    batches = _batches(device)
    m = EveryReduction(device=device)
    for x in batches[:3]:
        m(x)
    twin, pickled = m.clone(), pickle.loads(pickle.dumps(m))
    assert not twin._graphs.steps and not pickled._graphs.steps
    before = m.metric_state
    for x in batches[3:]:
        twin(x)
        pickled(x)
    assert _equal(m.metric_state, before)  # the original did not move with its copies
    for x in batches[3:]:
        m(x)
    assert _equal(m.metric_state, twin.metric_state) and _equal(m.metric_state, pickled.metric_state)


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_reset_and_load_state_dict_between_replays(device, monkeypatch):
    batches = _batches(device)
    source = EveryReduction(device=device)
    for x in batches[:2]:
        source.update(x)
    checkpoint = source.state_dict()

    def steps(m):
        out = [m(x) for x in batches[:3]]
        m.reset()
        out += [m(x) for x in batches[3:5]]
        m.load_state_dict(checkpoint)
        out += [m(x) for x in batches[5:]]
        return out, m.metric_state, m.update_count

    graph, _ = _drive(monkeypatch, "graph", lambda: EveryReduction(device=device), steps)
    eager, _ = _drive(monkeypatch, "eager", lambda: EveryReduction(device=device), steps)
    assert _equal(graph[:2], eager[:2]) and graph[2] == eager[2] == 5
    assert dispatch.STATS.captures == 1 and dispatch.STATS.replays == len(batches)


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_update_batches_and_fast_update_tiers(device, monkeypatch):
    stack = torch.stack(_batches(device, n=6))

    def steps(m):
        m.fast_update = True
        m.update(stack[0])
        m.update_batches(stack[1:])
        m.update(stack[0])
        return m.metric_state, m.compute()

    graph, _ = _drive(monkeypatch, "graph", lambda: EveryReduction(device=device), steps)
    assert dispatch.STATS.captures == 2 and dispatch.STATS.replays == 3 and not dispatch.STATS.fallbacks
    eager, _ = _drive(monkeypatch, "eager", lambda: EveryReduction(device=device), steps)
    assert _equal(graph, eager)


def test_capture_failure_falls_back_with_its_reason(monkeypatch):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    dispatch.STATS.reset()

    def refuse(*args, **kwargs):
        raise dispatch.CaptureError("refused")

    monkeypatch.setattr(dispatch, "capture", refuse)
    m = EveryReduction(device="cpu")
    x = _batches("cpu", n=1)[0]
    with pytest.warns(UserWarning, match="could not be captured"):
        m(x)
    m(x)
    assert dispatch.STATS.fallbacks[("EveryReduction", "forward", "capture_failed")] == 2
    assert m.update_count == 2 and float(m.compute()[0]) == 2 * float(x.sum())


def test_state_read_mid_flight_raises(monkeypatch):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)

    class Peeks(EveryReduction):
        def _compute(self, state):
            self.metric_state  # a callback that reads the state inside the step
            return super()._compute(state)

    with pytest.raises(TorchMetricsUserError, match="mid-flight"):
        Peeks(device="cpu")(_batches("cpu", n=1)[0])


def _path_a(device):
    kw = dict(num_classes=5, device=device, validate_args=False)
    return MetricCollection([tc.MulticlassAccuracy(average="micro", **kw), tc.MulticlassPrecision(**kw),
                             tc.MulticlassRecall(**kw), tc.MulticlassF1Score(**kw)])


def _path_f(device):
    return MetricCollection([tc.BinaryRecallAtFixedPrecision(0.5, thresholds=20, device=device),
                             tc.BinaryPrecisionAtFixedRecall(0.5, thresholds=20, device=device),
                             tc.BinarySpecificityAtSensitivity(0.5, thresholds=20, device=device),
                             tc.BinaryAUROC(thresholds=20, device=device)])


def _path_e(device):
    return MetricCollection([tc.BinaryAccuracy(device=device), tc.BinaryPrecision(device=device),
                             tc.BinaryRecall(device=device), tc.BinaryF1Score(device=device)])


COLLECTIONS = {"A": (_path_a, "labels"), "E": (_path_e, "binary"), "F": (_path_f, "binary")}


def _inputs(kind, device, n=6, size=500, seed=3):
    rng = np.random.RandomState(seed)
    if kind == "labels":
        preds, target = rng.randint(0, 5, (n, size)), rng.randint(0, 5, (n, size))
    else:
        preds, target = rng.rand(n, size).astype(np.float32), rng.randint(0, 2, (n, size))
    return torch.from_numpy(preds).to(device), torch.from_numpy(target.astype(np.int32)).to(device)


@pytest.mark.parametrize("path", sorted(COLLECTIONS))
@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_collection_forward_and_sweeps_bit_identical(device, monkeypatch, path):
    make, kind = COLLECTIONS[path]
    preds, target = _inputs(kind, device)
    counters = LAUNCHES[path]

    def steps(mc):
        before = [c.launches for c in counters]
        values = [mc(p, t) for p, t in zip(preds, target)]
        state = [m.metric_state for m in mc.values()]
        result = mc.compute()
        mc.reset()
        mc.update_batches(preds, target)
        swept = mc.sweep_fn()(preds, target)
        return (values, state, result, mc.compute(), swept), [c.launches - b for c, b in zip(counters, before)]

    (graph, graph_launches), mc = _drive(monkeypatch, "graph", lambda: make(device), steps)
    fallbacks, warmups = dict(dispatch.STATS.fallbacks), dispatch.STATS.warmup_launches
    (eager, eager_launches), _ = _drive(monkeypatch, "eager", lambda: make(device), steps)
    assert _equal(graph, eager)
    assert not fallbacks
    assert len(mc.compute_groups) == 1
    # four per-metric captures on the first step, the group's on the second, one sweep of each kind
    assert dispatch.STATS.captures == 4 + 1 + 1 + 1
    if device.type == "cuda":  # each replay adds the launches its capture held; the warm-ups' are real
        assert sum(graph_launches) == sum(eager_launches) + warmups
        assert eager_launches[0] == 4 + (len(preds) - 1) + len(preds) + len(preds)


LAUNCHES = {"A": [k1.BINCOUNT], "E": [k1.BINCOUNT], "F": [k3.BINNED_CONFMAT]}


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_sketch_fast_update_bit_identical(device, monkeypatch):
    rng = np.random.RandomState(17)
    scores = torch.from_numpy(rng.rand(6, 4096).astype(np.float32)).to(device)
    target = torch.from_numpy((rng.rand(6, 4096) < 0.5).astype(np.int32)).to(device)

    def steps(m):
        m.fast_update = True
        before = k2.SKETCH_UPDATE.launches
        for p, t in zip(scores, target):
            m.update(p, t)
        return (m.metric_state, m.compute()), k2.SKETCH_UPDATE.launches - before

    (graph, graph_launches), _ = _drive(monkeypatch, "graph", lambda: tc.BinaryAUROC(approx="sketch", device=device), steps)
    assert not dispatch.STATS.fallbacks and dispatch.STATS.replays == 6
    warmups = dispatch.STATS.warmup_launches
    (eager, eager_launches), _ = _drive(monkeypatch, "eager", lambda: tc.BinaryAUROC(approx="sketch", device=device), steps)
    assert _equal(graph, eager)
    if device.type == "cuda":
        assert graph_launches == eager_launches + warmups == 6 + 1


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_aggregation_collection_tiers(device, monkeypatch):
    values = torch.stack(_batches(device, n=6, size=40))

    def steps(mc):
        out = [mc(v) for v in values]
        mc.reset()
        mc.update_batches(values)
        return out, mc.compute(), mc.sweep_fn()(values)

    def make():
        return MetricCollection({"mean": MeanMetric(device=device), "max": MaxMetric(device=device),
                                 "sum": SumMetric(device=device)}, compute_groups=False)

    graph, _ = _drive(monkeypatch, "graph", make, steps)
    # MaxMetric's full_state_update forward is its update (fast_update is off) and a batch value
    assert set(dispatch.STATS.fallbacks) == {("MaxMetric", "update", "fast_update_class_off")}
    eager, _ = _drive(monkeypatch, "eager", make, steps)
    assert _equal(graph, eager)


@pytest.mark.cuda
def test_graphs_left_as_garbage_do_not_break_a_capture(monkeypatch):
    """A metric and its graphs form a reference cycle; a graph destroyed by the cyclic collector in
    the middle of another capture would invalidate that capture and send the step to the eager tier."""
    import gc

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph tier captures CUDA graphs")
    _graph(monkeypatch)
    dispatch.STATS.reset()
    device = torch.device("cuda", 0)
    x = _batches(device, n=1)[0]
    threshold = gc.get_threshold()
    gc.disable()
    try:
        for _ in range(5):
            EveryReduction(device=device)(x)  # each leaves its graph in an unreachable cycle
        gc.set_threshold(1)  # the collector would run at almost every allocation
        gc.enable()
        for size in (17, 23, 29):
            EveryReduction(device=device)(_batches(device, n=1, size=size)[0])
    finally:
        gc.set_threshold(*threshold)
        gc.enable()
    assert dispatch.STATS.captures == 8 and not dispatch.STATS.fallbacks
