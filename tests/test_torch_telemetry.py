"""The port's telemetry registry and the engine's hooks, against the JAX package.

The cases follow ``tests/unittests/bases/test_telemetry.py``: the instruments, activation and
thread safety; per-instance call counts, graph captures counted as traces (the port's counterpart
of a jit trace), the one-shot capture-churn warning and spans; the group forward's attribution to
its leader; survival through ``clone`` and pickle; ``describe_abstract``, ``tree_bytes`` and
``device_sync``. Where a counter means the same in both packages it must equal JAX's on the same
calls and numpy inputs: the call counts, ``engine.dispatches`` on the eager tier, and the keyed
counters (the sketch counters are held to JAX's in ``test_torch_sketch_kinds.py``). The export and
sync-event cases wait for the exporters (ROADMAP item 9).
"""
from __future__ import annotations

import pickle
import threading
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch import MetricCollection, obs
from torchmetrics_tpu_torch.aggregation import MeanMetric
from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassF1Score
from torchmetrics_tpu_torch.obs import Telemetry
from torchmetrics_tpu_torch.ops import dispatch

NUM_CLASSES = 5


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import torchmetrics_tpu as jtm
    from torchmetrics_tpu import obs as jobs

    return SimpleNamespace(jnp=jnp, tm=jtm, obs=jobs)


@pytest.fixture(autouse=True)
def _telemetry_isolated():
    prev = obs.retrace_warn_threshold()
    yield
    obs.disable()
    obs.set_retrace_warn_threshold(prev)


def _on_tier(tier: str, monkeypatch) -> None:
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", tier == "graph")
    if tier == "eager":
        monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
    else:
        monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)


def _mc_batch(n=32, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, NUM_CLASSES, n).astype(np.int32), rng.randint(0, NUM_CLASSES, n).astype(np.int32)


def _acc(**kw):
    return MulticlassAccuracy(num_classes=NUM_CLASSES, validate_args=False, device="cpu", **kw)


# ----------------------------------------------------------------------------- instruments
def test_counter_timer_gauge():
    t = Telemetry()
    t.counter("a").inc()
    t.counter("a").inc(4)
    assert t.counter("a").value == 5 and t.counter("b").value == 0
    t.timer("op").observe(0.5)
    t.timer("op").observe(1.5)
    assert t.timer("op").count == 2 and t.timer("op").total_s == pytest.approx(2.0) and t.timer("op").mean_s == 1.0
    t.gauge("g").set(3)
    assert t.gauge("g").value == 3.0 and isinstance(t.gauge("g").value, float)


@pytest.mark.parametrize("n", [0, 1, 100, 10_000])
def test_histogram_as_jax(jax, n):
    """Percentiles and summaries of the bounded reservoir, JAX's exactly (the empty case included)."""
    ours, theirs = Telemetry().histogram("lat"), jax.obs.Telemetry().histogram("lat")
    for v in range(1, n + 1):
        ours.record(float(v))
        theirs.record(float(v))
    assert ours.summary() == theirs.summary() and ours.count == theirs.count == n
    for p in (0, 50, 90, 99, 100):
        assert ours.percentile(p) == theirs.percentile(p)
    if n == 10_000:
        assert ours.summary()["min"] >= 10_000 - 4096


def test_thread_safety_counters():
    t = Telemetry()

    def work():
        for _ in range(1000):
            t.counter("c").inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert t.counter("c").value == 8000


# ------------------------------------------------------------------------------ activation
def test_env_var_parsing_as_jax(jax):
    from torchmetrics_tpu.obs.telemetry import _env_enabled as jax_env

    from torchmetrics_tpu_torch.obs.telemetry import _env_enabled

    for value in ("1", "true", "YES", " on ", "", "0", "false", "off", "nope"):
        assert _env_enabled({"TM_TPU_TELEMETRY": value}) == jax_env({"TM_TPU_TELEMETRY": value}), value
    assert (obs.ENV_FLAG, obs.ENV_RETRACE_THRESHOLD) == (jax.obs.ENV_FLAG, jax.obs.ENV_RETRACE_THRESHOLD)


def test_context_manager_restores():
    assert not obs.is_enabled()
    with obs.enabled():
        assert obs.is_enabled()
        with obs.enabled(False):
            assert not obs.is_enabled()
        assert obs.is_enabled()
    assert not obs.is_enabled()


def test_disabled_mode_is_noop():
    t = Telemetry(enabled=False)
    t.event("never")
    with t.span("never-timed"):
        pass
    assert t.events() == [] and t.snapshot()["timers"] == {}
    assert t.span("x") is t.span("y")  # the shared null scope: nothing allocated
    m = _acc()
    assert obs.metric_span(m, "update") is obs.metric_span(m, "compute")


def test_disabled_metric_records_no_events_or_times():
    obs.disable()
    m = _acc()
    before = len(obs.telemetry.events())
    m.update(*_mc_batch())
    m.compute()
    assert len(obs.telemetry.events()) == before
    assert m.telemetry["time_s"] == {}
    assert m.telemetry["calls"]["update"] == 1 and m.telemetry["dispatches"] >= 1


# -------------------------------------------------------------------- metric instrumentation
def _jax_acc(jax):
    from torchmetrics_tpu.classification import MulticlassAccuracy as J

    return J(num_classes=NUM_CLASSES, validate_args=False)


def _scenario(kind, ns, device):
    """One call sequence on the classes of ``ns`` (the port's or JAX's modules)."""
    cls, agg = ns
    if kind == "accuracy":
        m = cls.MulticlassAccuracy(num_classes=NUM_CLASSES, validate_args=False, **device)
        m.update(*_mc_batch())
        m.update(*_mc_batch(seed=1))
        m(*_mc_batch(seed=2))
        m.compute()
        m.compute()  # cached: a call, no dispatch
        return [m]
    if kind == "batches":
        m = cls.MulticlassAccuracy(num_classes=NUM_CLASSES, validate_args=False, **device)
        preds = np.random.RandomState(0).randint(0, NUM_CLASSES, (4, 16)).astype(np.int32)
        m.update_batches(preds, preds[::-1].copy())
        m.compute()
        return [m]
    if kind == "mean-max":
        mean, mx = agg.MeanMetric(**device), agg.MaxMetric(**device)  # MaxMetric: a full_state_update forward
        for v in (1.0, 2.0, 4.0):
            mean(np.asarray([v], np.float32))
            mx(np.asarray([v], np.float32))
        mean.compute()
        return [mean, mx]
    if kind == "exact-auroc":  # list states: the forward is not fusable (two dispatches)
        m = cls.BinaryAUROC(**device)
        rng = np.random.RandomState(3)
        m(rng.uniform(0, 1, 20).astype(np.float32), rng.randint(0, 2, 20).astype(np.int32))
        m.compute()
        return [m]
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["accuracy", "batches", "mean-max", "exact-auroc"])
def test_call_and_dispatch_counts_as_jax_on_the_eager_tier(jax, kind, monkeypatch):
    """Per-instance call counts and dispatches, and the global ``engine.dispatches``, equal JAX's."""
    import torchmetrics_tpu.aggregation as jagg
    import torchmetrics_tpu.classification as jcls

    import torchmetrics_tpu_torch.aggregation as pagg
    import torchmetrics_tpu_torch.classification as pcls

    _on_tier("eager", monkeypatch)
    before_p, before_j = obs.telemetry.counter("engine.dispatches").value, jax.obs.telemetry.counter("engine.dispatches").value
    ours = _scenario(kind, (pcls, pagg), {"device": "cpu"})
    theirs = _scenario(kind, (jcls, jagg), {})
    assert obs.telemetry.counter("engine.dispatches").value - before_p == \
        jax.obs.telemetry.counter("engine.dispatches").value - before_j
    for o, t in zip(ours, theirs):
        assert o.telemetry["calls"] == t.telemetry["calls"]
        assert o.telemetry["dispatches"] == t.telemetry["dispatches"]


def test_captures_count_as_traces(monkeypatch):
    """On the graph tier each capture is a trace of its step kind: one per signature, and a new
    batch size captures again (a retrace). Dispatches equal the graph replays."""
    _on_tier("graph", monkeypatch)
    m = _acc()
    replays = dispatch.STATS.replays
    for seed in range(3):
        m(*_mc_batch(seed=seed))
    t = m.telemetry
    assert t["calls"]["forward"] == 3 and t["traces"] == {"forward": 1} and t["retraces"] == {"forward": 0}
    assert t["dispatches"] == dispatch.STATS.replays - replays == 3
    m(*_mc_batch(64))
    t = m.telemetry
    assert t["traces"]["forward"] == 2 and t["retraces"]["forward"] == 1 and t["retraces_total"] == 1
    assert obs.telemetry.counter("jit.retrace.MulticlassAccuracy.forward").value >= 1


def test_eager_tier_records_no_trace(monkeypatch):
    _on_tier("eager", monkeypatch)
    m = _acc()
    m(*_mc_batch())
    m(*_mc_batch(64))
    assert m.telemetry["traces"] == {} and m.telemetry["dispatches"] == 2


def test_update_batches_and_fast_update_captures(monkeypatch):
    _on_tier("graph", monkeypatch)
    m = _acc()
    preds = np.random.RandomState(0).randint(0, NUM_CLASSES, (4, 16)).astype(np.int32)
    m.update_batches(preds, preds)
    m.update_batches(preds, preds)
    assert m.telemetry["calls"]["update_batches"] == 2 and m.telemetry["traces"] == {"update_batches": 1}
    mean = MeanMetric(device="cpu", nan_strategy="ignore")
    mean.fast_update = True
    for v in (1.0, 2.0):
        mean.update(np.asarray([v, v], np.float32))
    assert mean.telemetry["traces"] == {"update": 1} and mean.telemetry["dispatches"] == 2


def test_retrace_warning_one_shot(monkeypatch):
    """Past the threshold, one warning per instance naming the class and the latest capture key,
    and one ``jit.recompile_churn`` flight event."""
    from torchmetrics_tpu_torch.obs import flightrec

    _on_tier("graph", monkeypatch)
    obs.set_retrace_warn_threshold(2)
    m = _acc()
    seq = flightrec.last_seq()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for n in (8, 16, 24, 32, 40, 48):
            m(*_mc_batch(n))
    msgs = [str(w.message) for w in caught if "recaptured" in str(w.message)]
    assert len(msgs) == 1, msgs
    assert "MulticlassAccuracy" in msgs[0] and "cache key: i32[32];i32[32]" in msgs[0]
    assert "TPU004" not in msgs[0] and "XLA" not in msgs[0]
    churn = [e for e in flightrec.events() if e["seq"] > seq and e["kind"] == "jit.recompile_churn"]
    assert len(churn) == 1 and churn[0]["metric"] == "MulticlassAccuracy" and churn[0]["retraces"] == 3


def test_no_warning_below_threshold(monkeypatch):
    _on_tier("graph", monkeypatch)
    obs.set_retrace_warn_threshold(10)
    m = _acc()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m(*_mc_batch(8))
        m(*_mc_batch(16))
    assert not [w for w in caught if "recaptured" in str(w.message)]


def test_spans_recorded_when_enabled(monkeypatch):
    """One span per call: update, forward and compute, with the capture event on the graph tier."""
    _on_tier("graph", monkeypatch)
    with obs.enabled():
        m = _acc()
        before = len(obs.telemetry.events())
        m.update(*_mc_batch())
        m(*_mc_batch())
        m.compute()
        events = obs.telemetry.events()[before:]
    names = [e["name"] for e in events]
    for op in ("update", "forward", "compute"):
        assert names.count(f"metric.MulticlassAccuracy.{op}") == 1, names
    span = next(e for e in events if e["name"] == "metric.MulticlassAccuracy.forward")
    assert span["ph"] == "X" and span["dur"] >= 0 and span["cat"] == "metric"
    trace = next(e for e in events if e["name"] == "jit.trace.MulticlassAccuracy.forward")
    assert trace["args"] == {"cache_key": "i32[32];i32[32]", "trace_index": 1}
    assert m.telemetry["time_s"]["update"] > 0 and obs.telemetry.timer("metric.MulticlassAccuracy.compute").count >= 1


def test_telemetry_survives_clone_and_pickle():
    m = _acc()
    m.update(*_mc_batch())
    for twin in (m.clone(), pickle.loads(pickle.dumps(m))):
        assert twin.telemetry["calls"]["update"] == 1 and twin.telemetry["dispatches"] == 1


@pytest.mark.parametrize("tier", ["graph", "eager"])
def test_group_forward_attribution(jax, tier, monkeypatch):
    """The group step is attributed to its leader: ``group_forward`` calls and one dispatch a step
    (one replay on the graph tier, where it captures once), with JAX's call counts."""
    from torchmetrics_tpu import MetricCollection as JMC
    from torchmetrics_tpu.classification import MulticlassF1Score as JF1

    _on_tier(tier, monkeypatch)
    mc = MetricCollection([_acc(), MulticlassF1Score(num_classes=NUM_CLASSES, validate_args=False, device="cpu")])
    jmc = JMC([_jax_acc(jax), JF1(num_classes=NUM_CLASSES, validate_args=False)])
    replays = dispatch.STATS.replays
    for seed in range(3):
        mc(*_mc_batch(seed=seed))
        jmc(*_mc_batch(seed=seed))
    t, jt = mc.telemetry, jmc.telemetry
    leader = t["metrics"]["MulticlassAccuracy"]
    assert leader["calls"] == jt["metrics"]["MulticlassAccuracy"]["calls"] == {"forward": 1, "group_forward": 2}
    assert t["metrics"]["MulticlassF1Score"]["calls"] == jt["metrics"]["MulticlassF1Score"]["calls"]
    assert t["compute_groups"] == jt["compute_groups"] == {0: ["MulticlassAccuracy", "MulticlassF1Score"]}
    assert t["retraces_total"] == 0 and t["dispatches"] == 4
    if tier == "graph":
        assert leader["traces"] == {"forward": 1, "group_forward": 1}
        assert dispatch.STATS.replays - replays == t["dispatches"]


def test_compute_group_formation_event():
    with obs.enabled():
        mc = MetricCollection([_acc(), MulticlassF1Score(num_classes=NUM_CLASSES, validate_args=False, device="cpu")])
        formed = obs.telemetry.counter("collection.compute_groups.formed").value
        mc.update(*_mc_batch())
        evts = [e for e in obs.telemetry.events() if e["name"] == "collection.compute_groups"]
    assert evts and "MulticlassAccuracy" in str(evts[-1]["args"])
    assert obs.telemetry.counter("collection.compute_groups.formed").value == formed + 1


def test_keyed_counters_as_jax(jax):
    """``keyed.fanout``, ``keyed.active_keys`` and ``keyed.updates`` move by JAX's amounts."""
    from torchmetrics_tpu.aggregation import SumMetric as JSum
    from torchmetrics_tpu.keyed import KeyedMetric as JKeyed

    from torchmetrics_tpu_torch.aggregation import SumMetric
    from torchmetrics_tpu_torch.keyed import KeyedMetric

    names = ("keyed.fanout", "keyed.active_keys", "keyed.updates")
    rng = np.random.RandomState(5)
    ids = [rng.randint(0, 6, 9).astype(np.int32) for _ in range(3)]
    vals = [rng.randint(0, 9, 9).astype(np.float32) for _ in range(3)]

    def drive(keyed, tel, device):
        before = {n: tel.counter(n).value for n in names}
        km = keyed(SumMetric if device else JSum, 8, **device)
        for i, v in zip(ids, vals):
            km.update(i, v)
        km.update_batches(np.stack(ids), np.stack(vals))
        km.compute(keys=[1, 2])
        return {n: tel.counter(n).value - before[n] for n in names}, km.telemetry["calls"]

    ours = drive(KeyedMetric, obs.telemetry, {"device": "cpu"})
    theirs = drive(JKeyed, jax.obs.telemetry, {})
    assert ours == theirs and ours[0]["keyed.updates"] == 6


# ----------------------------------------------------------------------------- helpers
def test_describe_abstract_and_tree_bytes_as_jax(jax):
    ours = obs.describe_abstract(torch.zeros((4, 2)), np.int32(3), {"k": torch.zeros(3, dtype=torch.bool)}, 7)
    theirs = jax.obs.describe_abstract(jax.jnp.zeros((4, 2), jax.jnp.float32), np.int32(3),
                                       {"k": jax.jnp.zeros(3, bool)}, 7)
    assert ours == theirs == "f32[4,2];i32[];b8[3];int"
    assert obs.describe_abstract(torch.zeros(2, dtype=torch.int64), torch.zeros(1, dtype=torch.uint8)) == "i64[2];u8[1]"
    tree = {"a": torch.zeros((4, 2)), "b": [torch.zeros((3,), dtype=torch.int32)], "c": "x"}
    assert obs.tree_bytes(tree) == jax.obs.tree_bytes({"a": jax.jnp.zeros((4, 2)), "b": [jax.jnp.zeros((3,), jax.jnp.int32)]})
    assert obs.tree_bytes(tree) == 4 * 2 * 4 + 3 * 4


def test_device_sync_counts():
    before = obs.telemetry.counter("host.block_until_ready").value
    x = torch.ones(2)
    assert obs.device_sync(x) is x
    with obs.enabled():
        obs.device_sync({"a": x})
        assert obs.telemetry.timer("host.block_until_ready").count >= 1
    assert obs.telemetry.counter("host.block_until_ready").value == before + 2


def test_process_fingerprint_as_jax(jax):
    ours, theirs = obs.process_fingerprint(), jax.obs.process_fingerprint()
    assert sorted(ours) == sorted(theirs) and len(ours["fingerprint"]) == 8
    assert ours["process_index"] == 0 and ours["pid"] == theirs["pid"] and ours["host"] == theirs["host"]


def test_obs_exports_the_ported_names_of_jax_s(jax):
    """``obs`` exports every name of JAX's ``obs.__all__`` that its four ported modules define, and
    nothing of the rest (a missing name raises ``AttributeError``)."""
    import importlib

    ported_modules = ("telemetry", "flightrec", "timeseries", "slo")
    namespaces = [vars(importlib.import_module(f"torchmetrics_tpu.obs.{m}")) for m in ported_modules]
    wanted = {n for n in jax.obs.__all__
              if n in ported_modules or any(ns.get(n, namespaces) is getattr(jax.obs, n) for ns in namespaces)}
    assert sorted(wanted) == sorted(obs.__all__)
    with pytest.raises(AttributeError):
        obs.export_trace  # noqa: B018 - the exporters are not ported


def test_snapshot_and_reset():
    t = Telemetry(enabled=True)
    t.counter("c").inc(3)
    t.gauge("g").set(1.5)
    t.histogram("h").record(2.0)
    with t.span("s"):
        pass
    snap = t.snapshot()
    assert snap["counters"] == {"c": 3} and snap["gauges"] == {"g": 1.5} and snap["timers"]["s"]["count"] == 1
    assert snap["events_recorded"] == 1 and snap["histograms"]["h"]["count"] == 1
    t.reset()
    assert t.snapshot()["counters"] == {} and t.events() == []
    small = Telemetry(enabled=True, max_events=2)
    for i in range(5):
        small.event(f"e{i}")
    assert len(small.events()) == 2 and small.dropped_events == 3


def test_path_a_graph_step_adds_no_host_aten_op(monkeypatch):
    """The hooks are host Python: a steady graph-tier forward runs the same aten operations with
    telemetry off and on (the spans add none either)."""
    from torch.profiler import ProfilerActivity, profile

    _on_tier("graph", monkeypatch)
    mc = MetricCollection([_acc(), MulticlassF1Score(num_classes=NUM_CLASSES, validate_args=False, device="cpu")])
    batches = [tuple(torch.from_numpy(a) for a in _mc_batch(seed=s)) for s in range(4)]
    for b in batches[:2]:
        mc(*b)

    def aten_ops(enabled):
        with obs.enabled(enabled), profile(activities=[ProfilerActivity.CPU]) as prof:
            mc(*batches[2])
        return sorted(e.name for e in prof.events() if e.name.startswith("aten::"))

    assert aten_ops(False) == aten_ops(True)


def test_instrument_trace_as_jax(jax):
    """``instrument_trace`` records one trace per call of the wrapped body (JAX runs the body once
    per compile, under ``jax.jit``): the second call is a retrace, with the same counters and
    capture-key events in both packages."""
    from jax import jit

    from torchmetrics_tpu.obs.telemetry import instrument_trace as jax_instrument
    from torchmetrics_tpu_torch.obs.telemetry import instrument_trace

    class Owner:
        pass

    def body(x, scale=2):
        return x * scale

    results = {}
    for name, wrap, tel, enabled, arr, run in (
        ("torch", instrument_trace, obs.telemetry, obs.enabled, torch.ones, lambda f, x: f(x)),
        ("jax", jax_instrument, jax.obs.telemetry, jax.obs.enabled, jax.jnp.ones, lambda f, x: jit(f)(x)),
    ):
        owner = Owner()
        counters = ("jit.trace.Owner.update", "jit.retrace.Owner.update")
        before = {c: tel.counter(c).value for c in counters}
        n_events = len(tel.events())
        wrapped = wrap(body, owner, "update")
        with enabled():
            outs = [np.asarray(run(wrapped, arr(n))) for n in (4, 8)]
        events = [e for e in tel.events()[n_events:] if e["name"] == "jit.trace.Owner.update"]
        results[name] = (owner._tm_counts, {c: tel.counter(c).value - before[c] for c in counters},
                         [e["args"] for e in events], [o.tolist() for o in outs], wrapped.__name__)
    assert results["torch"] == results["jax"]
    assert results["torch"][0] == {"traces.update": 2} and results["torch"][1] == {
        "jit.trace.Owner.update": 2, "jit.retrace.Owner.update": 1}
