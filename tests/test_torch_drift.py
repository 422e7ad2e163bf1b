"""The drift detectors and ``DriftMonitor`` of the port against the JAX package.

The cases follow ``tests/unittests/online/test_drift.py``: the KS and PSI math (the port's host
scores within 1e-9 of JAX's on the same sketches, since both are float64 numpy over the same
support; the host score against ``kll_ks_distance`` and ``kll_psi``), ``EwmaBand`` with its state
round trip (JAX's scores), and ``DriftMonitor``: quiet over a stationary stream, one alarm with one
warning after a shift, the counters, ``subscribe``'s transitions and ``default_drift_specs``, with
JAX's verdicts and counters on the same stream.
"""
from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.online import (
    DriftMonitor,
    DriftSpec,
    EwmaBand,
    KsDrift,
    PsiDrift,
    Windowed,
    default_drift_specs,
)
from torchmetrics_tpu_torch.online.drift import _as_points, ks_distance_points, psi_points
from torchmetrics_tpu_torch.sketch import StreamingQuantile
from torchmetrics_tpu_torch.sketch.kll import kll_init, kll_ks_distance, kll_psi, kll_update
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu.online as jonline
    import torchmetrics_tpu.online.drift as jdrift
    import torchmetrics_tpu.sketch as jsketch
    from torchmetrics_tpu import obs as jobs
    from torchmetrics_tpu.utils.prints import reset_warning_cache

    return SimpleNamespace(online=jonline, drift=jdrift, sketch=jsketch, obs=jobs, reset=reset_warning_cache)


def _data(seed: int, loc: float = 0.0, n: int = 1024):
    return np.random.RandomState(seed).normal(loc, 1.0, n).astype(np.float32)


def _sq(values, ns=None):
    m = StreamingQuantile(q=0.5, capacity=32, levels=12, **CPU) if ns is None else \
        ns.sketch.StreamingQuantile(q=0.5, capacity=32, levels=12)
    m.update(values)
    return m


@pytest.fixture(scope="module")
def jax_sketches(jax):
    """JAX's sketched metrics of the KS and PSI cases, one per (seed, loc), built once."""
    return {key: _sq(_data(*key), jax) for key in ((0, 0.0), (0, 3.0), (0, 0.5), (1, 0.0))}


# ------------------------------------------------------------------ KS and PSI
@pytest.mark.parametrize("cur_loc, detector", [(0.0, "ks"), (3.0, "ks"), (0.0, "psi"), (3.0, "psi"), (0.5, "psi")])
def test_scores_as_jax(jax, jax_sketches, cur_loc, detector):
    cur, ref = _data(0, cur_loc), _data(1)
    ours = (KsDrift(_sq(cur), _sq(ref)) if detector == "ks" else PsiDrift(_sq(cur), _sq(ref), bins=10)).score()
    j_cur, j_ref = jax_sketches[(0, cur_loc)], jax_sketches[(1, 0.0)]
    theirs = (jax.online.KsDrift(j_cur, j_ref) if detector == "ks" else jax.online.PsiDrift(j_cur, j_ref, bins=10)).score()
    assert abs(ours - theirs) <= 1e-9
    if cur_loc == 0.0:
        assert ours < (0.08 if detector == "ks" else 0.05)
    elif cur_loc == 3.0:
        assert ours > (0.5 if detector == "ks" else 0.25)


def test_references_of_every_kind():
    """A reference may be raw samples (numpy or a tensor), a KLL state (numpy or a tensor) or a metric."""
    ref_values = _data(1)
    ref_metric = _sq(ref_values)
    state = ref_metric.metric_state["sketch"]
    cur = _sq(_data(2, 0.3))
    raw = KsDrift(cur, ref_values).score()
    assert raw == KsDrift(cur, torch.from_numpy(ref_values)).score()
    sketched = KsDrift(cur, ref_metric).score()
    assert sketched == KsDrift(cur, state).score() == KsDrift(cur, state.numpy()).score()
    assert abs(raw - sketched) < 0.05


def test_empty_window_scores_none():
    empty = StreamingQuantile(q=0.5, capacity=32, levels=12, **CPU)
    assert KsDrift(empty, _sq(_data(1))).score() is None and PsiDrift(empty, _sq(_data(1))).score() is None
    with pytest.raises(ValueError, match="bins >= 2"):
        PsiDrift(empty, _data(1), bins=1)
    with pytest.raises(TorchMetricsUserError, match="no state 'nope'"):
        KsDrift(empty, _data(1), state="nope").score()


def test_exact_cdfs_on_raw_samples(jax):
    a = (np.asarray([0.0, 1.0]), np.asarray([1.0, 1.0]))
    b = (np.asarray([5.0, 6.0]), np.asarray([1.0, 1.0]))
    assert ks_distance_points(a, b) == 1.0 and ks_distance_points(a, a) == 0.0
    rng = np.random.RandomState(4)
    x = (np.sort(rng.normal(0, 1, 300)), rng.uniform(0.5, 2, 300))
    y = (np.sort(rng.normal(0.4, 1.2, 200)), np.ones(200))
    assert ks_distance_points(x, y) == jax.drift.ks_distance_points(x, y)
    assert psi_points(x, y, bins=7) == jax.drift.psi_points(x, y, bins=7)
    # the edges: ties, signed zeros, infinities, NaN, zero weights, unsorted and empty supports
    specials = np.array([-np.inf, np.inf, np.nan, -0.0, 0.0, 1.0, 2.0, 3.0, -1.5])
    for _ in range(300):
        pts = []
        for n in rng.randint(0, 9, 2):
            v = rng.choice(specials, n) if rng.rand() < 0.5 else rng.randint(-3, 4, n).astype(np.float64)
            pts.append((v, rng.choice([0.0, 0.5, 1.0, 2.0], n)))
        assert ks_distance_points(*pts) == jax.drift.ks_distance_points(*pts), pts
        bins = int(rng.randint(2, 12))
        ours, theirs = psi_points(*pts, bins=bins), jax.drift.psi_points(*pts, bins=bins)
        assert ours == theirs or (np.isnan(ours) and np.isnan(theirs)), pts


def test_host_scores_against_the_sketch_twins():
    rng = np.random.RandomState(5)
    a = kll_update(kll_init(32, 12), torch.from_numpy(rng.normal(0, 1, 512).astype(np.float32)))
    b = kll_update(kll_init(32, 12), torch.from_numpy(rng.normal(1, 1, 512).astype(np.float32)))
    assert abs(float(kll_ks_distance(a, b)) - ks_distance_points(_as_points(a), _as_points(b))) < 1e-6
    ref = kll_update(kll_init(32, 12), torch.from_numpy(rng.normal(0, 1, 512).astype(np.float32)))
    cur = kll_update(kll_init(32, 12), torch.from_numpy(rng.normal(2, 1, 512).astype(np.float32)))
    device, host = float(kll_psi(ref, cur, bins=8)), psi_points(_as_points(ref), _as_points(cur), bins=8)
    assert device > 0.25 and host > 0.25 and abs(device - host) < 0.5


# ------------------------------------------------------------------ EWMA band
def test_ewma_band_as_jax(jax):
    rng = np.random.RandomState(2)
    stream = np.concatenate([rng.normal(10.0, 1.0, 60), rng.normal(30.0, 1.0, 5)])
    ours, theirs = EwmaBand(alpha=0.2, warmup=5), jax.online.EwmaBand(alpha=0.2, warmup=5)
    scores = [ours.observe(v) for v in stream]
    assert scores == [theirs.observe(v) for v in stream]
    live = [s for s in scores[:60] if s is not None]
    assert scores[:5] == [None] * 5 and max(live) < 5.0 and scores[60] > 10.0
    assert ours.state() == theirs.state()
    twin = EwmaBand(alpha=0.2, warmup=5)
    twin.restore(ours.state())
    assert twin.observe(4.0) == ours.observe(4.0) and twin.state() == ours.state()
    with pytest.raises(ValueError, match="alpha"):
        EwmaBand(alpha=0.0)


def test_ewma_band_reads_a_bound_metric():
    w = Windowed(StreamingQuantile(q=0.5, capacity=32, levels=12, **CPU), 2, advance_every=2, emit=False)
    w.update(_data(0, n=64))
    band = EwmaBand(metric=w, warmup=1)
    assert band.score() is None and band.score() is not None
    with pytest.raises(TorchMetricsUserError, match="no bound metric"):
        EwmaBand().score()
    wide = Windowed(StreamingQuantile(q=(0.5, 0.9), capacity=8, **CPU), 2, emit=False)
    wide.update(_data(0, n=16))
    with pytest.raises(TorchMetricsUserError, match="scalar value stream"):
        EwmaBand(metric=wide).score()


# ------------------------------------------------------------------ the monitor
def _monitor_run(ns, name, seed=4):
    """JAX's ``test_alarm_fires_once_on_shift_quiet_on_stationary`` on one package: 10 stationary
    batches, then 10 shifted by +5, evaluated after each update with the clock pinned."""
    rng = np.random.RandomState(seed)
    kw = dict(q=0.5, capacity=32, levels=12)
    if ns is None:
        w = Windowed(StreamingQuantile(**kw, **CPU), 3, advance_every=2, emit=False)
        spec_cls, ks, monitor_cls, tel = DriftSpec, KsDrift, DriftMonitor, obs.telemetry
    else:
        w = ns.online.Windowed(ns.sketch.StreamingQuantile(**kw), 3, advance_every=2, emit=False)
        spec_cls, ks, monitor_cls, tel = ns.online.DriftSpec, ns.online.KsDrift, ns.online.DriftMonitor, ns.obs.telemetry
    ref = rng.normal(0, 1, 4096).astype(np.float32)
    mon = monitor_cls([spec_cls(name=name, detector=ks(w, ref), threshold=0.15, windows=((5.0, 1.0),))])
    transitions = []
    mon.subscribe(lambda status, firing: transitions.append((status.spec.name, firing)))
    counters = ("drift.evaluations", f"drift.alarms.{name}", "drift.alarms", f"slo.alarms.{name}")
    before = {c: tel.counter(c).value for c in counters}
    now, verdicts = 1000.0, []
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for loc in [0.0] * 10 + [5.0] * 10:
            w.update(rng.normal(loc, 1, 128).astype(np.float32))
            now += 1.0
            (status,) = mon.evaluate(now=now)
            verdicts.append((status.as_dict(), status.drifting))
    fired = [str(x.message) for x in rec if "burning" in str(x.message)]
    deltas = {c: tel.counter(c).value - before[c] for c in counters}
    return verdicts, fired, deltas, transitions, mon.drifting()


def test_alarm_fires_once_on_shift_quiet_on_stationary(jax):
    jax.reset()
    # a name of its own: JAX's own drift tests record "t-drift" into the same process's registry
    ours = _monitor_run(None, "t-drift-parity")
    theirs = _monitor_run(jax, "t-drift-parity")
    verdicts, fired, deltas, transitions, drifting = ours
    assert not any(d for _, d in verdicts[:10]) and any(d for _, d in verdicts[10:])
    assert len(fired) == 1 and deltas["drift.evaluations"] == 20 and deltas["drift.alarms.t-drift-parity"] >= 1
    assert transitions == [("t-drift-parity", True)] and drifting == ["t-drift-parity"]
    assert deltas == theirs[2] and fired == theirs[1] and transitions == theirs[3] and drifting == theirs[4]
    for (o, od), (t, td) in zip(verdicts, theirs[0]):
        assert od == td and o["slo"] == t["slo"]
        assert (o["score"] is None) == (t["score"] is None)
        if o["score"] is not None:
            assert abs(o["score"] - t["score"]) <= 1e-6


def test_scores_recorded_as_series_and_gauge_and_empty_window():
    mon = DriftMonitor([DriftSpec(name="t-drift-series", detector=KsDrift(_sq(_data(0)), _sq(_data(1))), threshold=0.15,
                                  windows=((5.0, 1.0),))])
    (status,) = mon.evaluate(now=50.0)
    series = obs.telemetry.get_series("drift.t-drift-series.score")
    assert series is not None and series.count >= 1 and obs.telemetry.gauge("drift.t-drift-series.score").value == status.score
    empty = StreamingQuantile(q=0.5, capacity=32, levels=12, **CPU)
    mon = DriftMonitor().watch(DriftSpec(name="t-drift-empty", detector=KsDrift(empty, _sq(_data(1))), threshold=0.15,
                                         windows=((5.0, 1.0),)))
    (status,) = mon.evaluate(now=60.0)
    assert status.score is None and not status.drifting and status.as_dict()["score"] is None


def test_subscribers_see_both_transitions():
    class Fixed:
        value = 0.0

        def score(self):
            return self.value

    det = Fixed()
    mon = DriftMonitor([DriftSpec(name="t-drift-flip", detector=det, threshold=1.0, windows=((1.5, 1.0),))])
    seen = []
    mon.subscribe(lambda status, firing: seen.append(firing))
    for t, v in enumerate([0.0, 5.0, 5.0, 5.0, 0.0, 0.0, 0.0]):
        det.value = v
        mon.evaluate(now=100.0 + t)
    assert seen == [True, False]


def test_default_drift_specs_as_jax(jax, jax_sketches):
    ours = default_drift_specs(_sq(_data(0)), _sq(_data(1)))
    theirs = jax.online.default_drift_specs(jax_sketches[(0, 0.0)], jax_sketches[(1, 0.0)])
    assert [s.name for s in ours] == [s.name for s in theirs] == ["streamingquantile-drift-ks", "streamingquantile-drift-psi"]
    assert isinstance(ours[0].detector, KsDrift) and isinstance(ours[1].detector, PsiDrift)
    for o, t in zip(ours, theirs):
        assert (o.threshold, o.objective, o.windows, o.description) == (t.threshold, t.objective, t.windows, t.description)
        assert o.as_slo_spec().__dict__ == t.as_slo_spec().__dict__
    assert [s.name for s in obs.default_drift_specs(_sq(_data(0)), _data(1), name="x")] == ["x-ks", "x-psi"]


def test_monitor_reads_each_window_once_per_evaluation():
    rng = np.random.RandomState(6)
    w = Windowed(StreamingQuantile(q=0.5, capacity=32, levels=12, **CPU), 3, advance_every=2, emit=False)
    for _ in range(5):
        w.update(rng.normal(0.5, 1, 128).astype(np.float32))
    specs = default_drift_specs(w, _data(1), name="t-drift-once", windows=((5.0, 1.0),))
    reads = []
    window_state = w.window_state
    w.window_state = lambda: reads.append(1) or window_state()
    statuses = DriftMonitor(specs).evaluate(now=200.0)
    assert len(reads) == 1
    assert [s.score for s in statuses] == [s.detector.score() for s in specs] and len(reads) == 3
