"""The port's live time series, SLO burn-rate monitor and flight recorder against the JAX package.

The cases follow ``tests/unittests/obs/test_timeseries.py``, ``test_slo.py`` and
``test_flightrec.py``, less their ``summary`` / ``bench_extras`` cases (the exporters are not ported:
ROADMAP item 9). The series' KLL sketch must equal JAX's bit for bit after 1, 1,023, 1,024 and
5,000 records (no fold, no fold, one full fold, four full folds and a flushed remainder), on the
emulated graph tier (the full fold one captured graph per geometry) and on the eager tier. SLO
verdicts, burn rates, warnings and counters must equal JAX's exactly on the same synthetic series.
"""
from __future__ import annotations

import threading
import warnings
from dataclasses import asdict
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.obs import flightrec
from torchmetrics_tpu_torch.obs.flightrec import FlightRecorder
from torchmetrics_tpu_torch.obs.slo import SloMonitor, SloSpec, default_fleet_specs, default_serve_specs
from torchmetrics_tpu_torch.obs.telemetry import Telemetry
from torchmetrics_tpu_torch.obs.timeseries import TimeSeries, merged_quantiles
from torchmetrics_tpu_torch.ops import dispatch


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import importlib

    # ``torchmetrics_tpu.obs.telemetry`` is also the name of the registry instance: import the modules
    mods = {k: importlib.import_module(f"torchmetrics_tpu.obs.{m}")
            for k, m in (("slo", "slo"), ("tel", "telemetry"), ("ts", "timeseries"), ("flightrec", "flightrec"))}
    return SimpleNamespace(**mods)


@pytest.fixture(autouse=True)
def _no_open_incident():
    yield
    flightrec.clear_incidents()


def _on_tier(tier: str, monkeypatch) -> None:
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", tier == "graph")
    if tier == "eager":
        monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
    else:
        monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)


# ----------------------------------------------------------------------------- the series
@pytest.mark.parametrize("tier", ["graph", "eager"])
@pytest.mark.parametrize("n", [1, 1023, 1024, 5000])
def test_series_sketch_bit_for_bit_as_jax(jax, n, tier, monkeypatch):
    _on_tier(tier, monkeypatch)
    values = np.random.RandomState(n).normal(0.0, 100.0, n)
    ours, theirs = TimeSeries("t", device="cpu"), jax.ts.TimeSeries("t")
    for i, v in enumerate(values):
        ours.record(float(v), now=float(i))
        theirs.record(float(v), now=float(i))
    qs = (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)
    assert ours.sketch_payload() == theirs.sketch_payload()
    assert ours.quantiles(qs) == theirs.quantiles(qs)
    ours.flush()
    theirs.flush()
    payload = ours.sketch_payload()
    assert payload == theirs.sketch_payload() and payload["pending"] == [] and payload["sketch"] is not None
    assert ours.quantiles(qs) == theirs.quantiles(qs)
    assert ours.summary() == theirs.summary() and ours.count == n and ours.total == theirs.total
    assert ours.sketch.device == torch.device("cpu")


def test_full_fold_is_one_capture_per_geometry(monkeypatch):
    """Every full fold of every series of one geometry replays one shared capture."""
    from torchmetrics_tpu_torch.obs import timeseries

    _on_tier("graph", monkeypatch)
    monkeypatch.setattr(timeseries, "_FOLD", None)
    a, b = TimeSeries("a", fold_every=64, device="cpu"), TimeSeries("b", fold_every=64, device="cpu")
    captures, replays = dispatch.STATS.captures, dispatch.STATS.replays
    for v in range(64 * 3):
        a.record(float(v))
        b.record(float(-v))
    assert dispatch.STATS.captures - captures == 1 and dispatch.STATS.replays - replays == 6
    assert timeseries._FOLD.__dict__["_tm_counts"] == {"traces.kll_fold": 1}
    b.record(1.0)
    b.flush()  # a remainder of one folds eagerly
    assert dispatch.STATS.captures - captures == 1


def test_quantiles_track_numpy_percentile():
    rng = np.random.RandomState(7)
    vals = rng.randn(20_000).astype(np.float64) * 100.0
    ts = TimeSeries("t", fold_every=512, device="cpu")
    for v in vals:
        ts.record(float(v))
    for q in (0.1, 0.5, 0.9, 0.99):
        rank = float(np.searchsorted(np.sort(vals), ts.quantile(q))) / len(vals)
        assert abs(rank - q) <= 0.03, q


def test_empty_series_and_pending_reads():
    ts = TimeSeries("t", device="cpu")
    assert ts.count == 0 and ts.last is None and ts.quantile(0.5) is None and ts.quantiles((0.5, 0.99)) == [None, None]
    ts = TimeSeries("t", fold_every=10_000, device="cpu")
    for i in range(100):
        ts.record(float(i))
    assert abs(ts.quantile(0.5) - 49.5) <= 5.0 and ts.sketch is None  # read without folding


def test_series_device_is_the_card_unless_named(monkeypatch):
    """Recording host points needs no card; the first fold resolves ``device=None`` to the card and
    raises without one, as every entry point of the port does."""
    from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ts = TimeSeries("t", fold_every=4)
    for v in range(3):
        ts.record(float(v))
    assert ts.quantile(0.5) == 1.0
    with pytest.raises(TorchMetricsUserError, match="device='cpu'"):
        ts.record(3.0)
    assert Telemetry(device="cpu").series("x")._device == "cpu"


def test_windowed_views():
    ts = TimeSeries("t", device="cpu")
    for i in range(100):
        ts.record(float(i), now=float(i))
    assert len(ts.window(9.5, now=99.0)) == 10 and ts.window(0.5, now=99.0) == [99.0]
    ts = TimeSeries("t", device="cpu")
    for i in range(50):
        ts.record(1.0, now=100.0 + i * 0.1)
    assert ts.rate_over(5.0, now=104.9) == pytest.approx(10.0, rel=0.1) and ts.rate_over(5.0, now=200.0) == 0.0
    ts = TimeSeries("t", device="cpu")
    ts.record(2.0, now=1.0)
    ts.record(4.0, now=2.0)
    assert ts.mean_over(10.0, now=2.0) == pytest.approx(3.0) and ts.mean_over(0.5, now=100.0) is None
    ts = TimeSeries("t", device="cpu")
    for i in range(10):
        ts.record(float(i), now=float(i))
    assert ts.bad_fraction_over(100.0, 6.5, "above", now=9.0) == pytest.approx(0.3)
    assert ts.bad_fraction_over(100.0, 2.5, "below", now=9.0) == pytest.approx(0.3)
    assert ts.bad_fraction_over(0.1, 0.0, "above", now=1000.0) is None


def test_bounded_memory_as_jax(jax):
    ts = TimeSeries("t", fold_every=64, device="cpu")
    b0 = ts.state_bytes()
    for i in range(2000):
        ts.record(float(i % 17))
    assert ts.state_bytes() == b0 == jax.ts.TimeSeries("t", fold_every=64).state_bytes()
    assert len(ts._pending) <= 64
    ring = TimeSeries("t", points=16, device="cpu")
    for i in range(100):
        ring.record(float(i), now=float(i))
    assert len(ring.window(1000.0, now=99.0)) == 16 and ring.count == 100


def test_registry_wiring():
    t = Telemetry(enabled=False, device="cpu")
    s1 = t.series("x.y")
    assert t.series("x.y") is s1 and t.get_series("x.y") is s1 and t.get_series("missing") is None
    assert t.series_names() == ["x.y"]
    for i in range(10):
        s1.record(float(i))
    snap = t.snapshot()
    assert snap["series"]["x.y"]["count"] == 10 and "p99" in snap["series"]["x.y"] and snap["series"]["x.y"]["sum"] == 45.0
    t.gauge("g").set(5.0)
    t.reset()
    assert t.get_series("x.y") is None and t.snapshot()["gauges"] == {}


def test_merged_quantiles_as_jax(jax):
    """Peers of one geometry merge with ``kll_merge``; pending samples join raw; the answer JAX's."""
    rng = np.random.RandomState(3)
    ours, theirs = [], []
    for n, fold in ((3000, 512), (1100, 512), (40, 1024)):
        o, t = TimeSeries("p", fold_every=fold, device="cpu"), jax.ts.TimeSeries("p", fold_every=fold)
        for v in rng.lognormal(2.0, 1.0, n):
            o.record(float(v))
            t.record(float(v))
        ours.append(o.sketch_payload())
        theirs.append(t.sketch_payload())
    qs = (0.01, 0.5, 0.9, 0.999)
    assert merged_quantiles(ours, qs, device="cpu") == jax.ts.merged_quantiles(theirs, qs)
    assert merged_quantiles([], qs) == [None] * 4


# ----------------------------------------------------------------------------- the SLO monitor
def _latency(tel_cls, bad_every: int):
    """200 samples over 20 s of synthetic time; every ``bad_every``-th exceeds 100."""
    t = tel_cls(enabled=False, **({"device": "cpu"} if tel_cls is Telemetry else {}))
    s = t.series("lat")
    for i in range(200):
        s.record(1000.0 if (bad_every and i % bad_every == 0) else 10.0, now=100.0 + i * 0.1)
    return t


def _storm(tel_cls):
    t = tel_cls(enabled=False, **({"device": "cpu"} if tel_cls is Telemetry else {}))
    s = t.series("lat")
    for i in range(100):
        s.record(1000.0, now=100.0 + i * 0.1)
    for i in range(100):
        s.record(10.0, now=150.0 + i * 0.1)
    return t


def _sheds(tel_cls, traffic: bool = True):
    t = tel_cls(enabled=False, **({"device": "cpu"} if tel_cls is Telemetry else {}))
    sheds, offered = t.series("sheds"), t.series("offered")
    for i in range(100 if traffic else 0):
        offered.record(1.0, now=100.0 + i * 0.1)
        if i % 4 == 0:
            sheds.record(1.0, now=100.0 + i * 0.1)
    return t


SLO_CASES = {
    "ten-percent-bad": (lambda c: _latency(c, 10), dict(name="lat", series="lat", objective=0.99, threshold=100.0,
                                                        windows=((5.0, 1.0), (20.0, 1.0))), (120.0,)),
    "healthy": (lambda c: _latency(c, 0), dict(name="lat", series="lat", objective=0.99, threshold=100.0,
                                               windows=((5.0, 1.0), (20.0, 1.0))), (120.0,)),
    "and-gate": (_storm, dict(name="lat", series="lat", objective=0.99, threshold=100.0,
                              windows=((5.0, 1.0), (100.0, 1.0))), (160.0,)),
    "empty-window": (lambda c: _latency(c, 2), dict(name="lat", series="lat", windows=((5.0, 1.0),)), (1000.0,)),
    "missing-series": (lambda c: _latency(c, 2), dict(name="lat", series="never.recorded", windows=((5.0, 1.0),)),
                       (100.0,)),
    "below": (lambda c: _latency(c, 3), dict(name="floor", series="lat", objective=0.9, threshold=500.0,
                                             bad_when="below", windows=((20.0, 2.0),)), (120.0,)),
    "shed-ratio": (_sheds, dict(name="shed", series="sheds", ratio_of="offered", objective=0.999,
                                windows=((10.0, 1.0),)), (110.0,)),
    "no-traffic": (lambda c: _sheds(c, False), dict(name="shed", series="sheds", ratio_of="offered",
                                                    windows=((10.0, 1.0),)), (100.0,)),
    "on-off-on": (lambda c: _latency(c, 2), dict(name="lat", series="lat", objective=0.99, threshold=100.0,
                                                 windows=((20.0, 1.0),)), (120.0, 120.5, 500.0, 119.0)),
}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_verdicts_warnings_and_counters_as_jax(jax, case):
    from torchmetrics_tpu.utils.prints import reset_warning_cache

    build, spec_kw, clocks = SLO_CASES[case]
    runs = []
    for tel_cls, spec_cls, monitor_cls in ((Telemetry, SloSpec, SloMonitor),
                                           (jax.tel.Telemetry, jax.slo.SloSpec, jax.slo.SloMonitor)):
        reset_warning_cache()
        t = build(tel_cls)
        mon = monitor_cls([spec_cls(**spec_kw)], registry=t)
        statuses = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for now in clocks:
                statuses.append([st.as_dict() for st in mon.evaluate(now=now)])
        snap = t.snapshot()
        runs.append((statuses, [str(w.message) for w in caught if "SLO" in str(w.message)], mon.burning(),
                     snap["counters"], snap["gauges"]))
    assert runs[0] == runs[1]


def test_alarm_evidence():
    t = _latency(Telemetry, 2)
    mon = SloMonitor([SloSpec(name="lat", series="lat", objective=0.99, threshold=100.0, windows=((20.0, 1.0),))],
                     registry=t)
    seq = flightrec.last_seq()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mon.evaluate(now=120.0)
        mon.evaluate(now=120.5)  # still burning: the counter moves, the warning does not
    assert sum("SLO 'lat' burning" in str(w.message) for w in caught) == 1
    assert t.counter("slo.alarms.lat").value == 2 and t.counter("slo.evaluations").value == 2
    assert t.gauge("slo.lat.burn_rate").value > 1.0 and mon.burning() == ["lat"]
    alarms = [e for e in flightrec.events() if e["seq"] > seq and e["kind"] == "slo.alarm"]
    assert len(alarms) == 1 and alarms[0]["burning"] is True and alarms[0]["name"] == "lat"


@pytest.mark.parametrize("kw", [dict(objective=1.0), dict(objective=0.0), dict(bad_when="sideways"), dict(scope="x"),
                                dict(windows=((0.0, 1.0),)), dict(windows=()), dict(windows=((5.0, -1.0),))])
def test_spec_checks_as_jax(jax, kw):
    with pytest.raises(ValueError) as ours:
        SloSpec(name="x", series="s", **kw)
    with pytest.raises(ValueError) as theirs:
        jax.slo.SloSpec(name="x", series="s", **kw)
    assert str(ours.value) == str(theirs.value)
    assert SloSpec(name="x", series="s", objective=0.99).budget == pytest.approx(0.01)


def test_default_specs_and_signals_as_jax(jax):
    for ours, theirs in ((default_serve_specs(), jax.slo.default_serve_specs()),
                         (default_fleet_specs(), jax.slo.default_fleet_specs()),
                         (default_serve_specs(0.9, 1.0, 0.99, ((1.0, 1.0),)),
                          jax.slo.default_serve_specs(0.9, 1.0, 0.99, ((1.0, 1.0),)))):
        assert [asdict(s) for s in ours] == [asdict(s) for s in theirs]
    assert SloMonitor([], registry=Telemetry(enabled=False)).signals() == \
        jax.slo.SloMonitor([], registry=jax.tel.Telemetry(enabled=False)).signals()
    t, jt = Telemetry(enabled=False, device="cpu"), jax.tel.Telemetry(enabled=False)
    for tel in (t, jt):
        for i in range(50):
            tel.series("serve.queue_depth").record(float(i % 7), now=10.0 + i * 0.1)
            tel.series("serve.commit_latency_us").record(100.0 + i, now=10.0 + i * 0.1)
            if i % 5 == 0:
                tel.series("serve.sheds").record(1.0, now=10.0 + i * 0.1)
    assert SloMonitor([], registry=t).signals(5.0, now=15.0) == jax.slo.SloMonitor([], registry=jt).signals(5.0, now=15.0)


# ----------------------------------------------------------------------------- the flight recorder
def test_record_is_always_on_and_holds_no_tensor():
    rec = FlightRecorder()
    with obs.enabled(False):
        rec.record("sync.downgrade", level="quorum")
    (evt,) = rec.events()
    assert evt["kind"] == "sync.downgrade" and evt["level"] == "quorum" and set(evt) == {"kind", "level", "seq", "ts_us"}


def test_sequence_numbers_and_bounds():
    a, b = FlightRecorder(), FlightRecorder()
    s1, s2, s3 = a.record("x"), b.record("y"), a.record("z")
    assert s1 < s2 < s3 and a.last_seq == s3 and b.last_seq == s2
    rec = FlightRecorder(maxlen=4)
    for i in range(10):
        rec.record("tick", i=i)
    snap = rec.snapshot()
    assert len(rec) == 4 and rec.dropped == 6 and snap["recorded"] == 10 and snap["dropped"] == 6
    assert [e["i"] for e in snap["events"]] == [6, 7, 8, 9] and snap["maxlen"] == 4
    rec.clear()
    assert len(rec) == 0 and rec.dropped == 0 and rec.last_seq == 0


def test_snapshot_orders_by_sequence_under_threads():
    rec = FlightRecorder()
    barrier = threading.Barrier(4)

    def spam():
        barrier.wait()
        for _ in range(200):
            rec.record("race")

    threads = [threading.Thread(target=spam) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seqs = [e["seq"] for e in rec.snapshot()["events"]]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs) == 800


def test_record_bumps_always_on_counter():
    before = obs.telemetry.counter("flight.events").value
    flightrec.record("counter.check")
    assert obs.telemetry.counter("flight.events").value == before + 1


def test_incidents(monkeypatch):
    inc_id = flightrec.open_incident("sync_timeout")
    assert inc_id.startswith(f"inc-{obs.process_fingerprint()['fingerprint']}-") and flightrec.current_incident() == inc_id
    flightrec.record("some.event", x=1)
    assert flightrec.events()[-1]["incident"] == inc_id
    assert flightrec.open_incident("serve_drain_death") == inc_id  # a cascade joins one incident
    assert any(i["id"] == inc_id for i in flightrec.recent_incidents())
    flightrec.adopt_incident("inc-cafebabe-0042", reason="gossip")
    assert flightrec.current_incident() == "inc-cafebabe-0042" and flightrec.events()[-1]["kind"] == "incident.adopted"
    monkeypatch.setenv(flightrec.ENV_INCIDENT_WINDOW, "0")
    assert flightrec.current_incident() is None  # a 0 s window ages out at once
    assert flightrec.open_incident("again") != inc_id
    flightrec.clear_incidents()
    flightrec.record("plain.event")
    assert "incident" not in flightrec.events()[-1]


def test_environment_names_as_jax(jax):
    assert (flightrec.ENV_FLIGHT_EVENTS, flightrec.ENV_INCIDENT_WINDOW) == \
        (jax.flightrec.ENV_FLIGHT_EVENTS, jax.flightrec.ENV_INCIDENT_WINDOW)
    assert sorted(flightrec.__all__) == sorted(jax.flightrec.__all__)
    assert jax.ts.DEFAULT_POINTS == 2048 == TimeSeries("t")._points.maxlen
    assert (jax.ts.DEFAULT_FOLD_EVERY, jax.ts._SERIES_CAPACITY, jax.ts._SERIES_LEVELS) == (1024, 64, 18)
