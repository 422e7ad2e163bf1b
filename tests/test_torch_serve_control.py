"""The port's serving controller (``serve/control.py``) against the JAX package's.

- For a seeded calm/overload sequence of offers, the controller's transitions, decisions, sheds, journaled
  ``shed_seqs`` and channel reports equal JAX's; each package reads the other's decision journal.
- ``ControlOptions``' checks and env knobs; the admission ladder on a real engine sheds (journaled) instead of
  raising, and ``adaptive_recover`` replays the WAL less the sheds to the live bits.
- A WAL and control journal that a JAX served metric wrote recover into the port's metric (``adaptive_recover``,
  ``recover``) with JAX's values.
- ``SharedDrain``: two engines, one thread, FIFO per engine; its restart latch; detach.
- ``DriftSnapshotter`` on the port's drift monitor; the jittered park's chaos-seeded RNG.
"""
from __future__ import annotations

import os
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

import torchmetrics_tpu_torch as port
import torchmetrics_tpu_torch.serve as port_serve
from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.obs import bundle
from torchmetrics_tpu_torch.online.drift import DriftDetector, DriftMonitor, DriftSpec
from torchmetrics_tpu_torch.parallel.sync import reset_backoff_rng
from torchmetrics_tpu_torch.robust import checkpoint as ckpt
from torchmetrics_tpu_torch.robust import journal
from torchmetrics_tpu_torch.serve import (
    ControlOptions,
    DriftSnapshotter,
    ServeController,
    ServeOptions,
    SharedDrain,
    adaptive_recover,
    control_options_from_env,
    shed_seqs,
)
from torchmetrics_tpu_torch.serve.control import CONTROL_DIR_SUFFIX
from torchmetrics_tpu_torch.serve.engine import _BLOCK_WAIT_MAX_S, _BLOCK_WAIT_MIN_S, _jittered_wait
from torchmetrics_tpu_torch.utils.exceptions import BackpressureError, ServeError

CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu as jt
    from torchmetrics_tpu import serve as jserve
    from torchmetrics_tpu.robust import journal as jjournal
    from torchmetrics_tpu.serve import control as jcontrol
    from torchmetrics_tpu.utils import exceptions as jexc

    return SimpleNamespace(top=jt, serve=jserve, control=jcontrol, journal=jjournal, exc=jexc)


@pytest.fixture(autouse=True)
def _bundles_in_tmp(tmp_path):
    with bundle.capture_dir(str(tmp_path / "bundles")):
        yield


class _StubEngine:
    """The controller-facing engine surface: options, the attach seam, depth fields, an optional WAL path."""

    def __init__(self, options, wal=None):
        self.options = options
        self.journal = SimpleNamespace(path=wal) if wal else None
        self._control = None
        self._queue: list = []
        self._applying_n = 0

    def attach_controller(self, control):
        self._control = control


def _fast(**over):
    base = dict(decision_every=2, window_short=4, window_long=8, min_hold_ticks=4, timed_block_timeout_s=0.01)
    base.update(over)
    return base


def _calm_overload_offers(seed=31, n=160):
    """A seeded square wave of offers: calm phases at low occupancy, overload phases at a full window with
    sheds, with random depth jitter."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        hot = (i // 20) % 2 == 1
        depth = 8 if hot and rng.rand() < 0.8 else int(rng.randint(0, 4 if not hot else 8))
        out.append((depth, bool(hot and rng.rand() < 0.3)))
    return out


def _drive(serve_mod, wal, offers, **opts):
    ctrl = serve_mod.ServeController(serve_mod.ControlOptions(**_fast(**opts)))
    eng = _StubEngine(serve_mod.ServeOptions(max_inflight=8, on_full="block", coalesce=8, linger_ms=0.0), wal=wal)
    ctrl.attach(eng)
    reports = []
    for seq, (depth, shed) in enumerate(offers):
        ctrl.note_offered(eng, depth, shed=shed, wal_seq=seq)
        if seq % 10 == 9:
            reports.append(ctrl.channel_report(eng))
    return ctrl, eng, reports


@pytest.mark.parametrize("seed", [31, 47])
def test_controller_decisions_match_jax(jax, tmp_path, seed):
    offers = _calm_overload_offers(seed)
    ours, ours_eng, ours_reports = _drive(port_serve, str(tmp_path / "port"), offers)
    theirs, theirs_eng, theirs_reports = _drive(jax.serve, str(tmp_path / "jax"), offers)
    assert ours.decisions == theirs.decisions
    assert ours.stats() == theirs.stats()
    assert ours_reports == theirs_reports
    assert ours.toggle_rate_ok(ours_eng) and theirs.toggle_rate_ok(theirs_eng)
    assert ours.stats()["escalations"] >= 1 and ours.stats()["deescalations"] >= 1
    assert {r["mode"] for r in ours_reports} == {"block", "timed", "shed"}  # the whole ladder, both ways
    # the decision journals hold the same sheds, and each package reads the other's
    ours_dir, theirs_dir = str(tmp_path / "port") + CONTROL_DIR_SUFFIX, str(tmp_path / "jax") + CONTROL_DIR_SUFFIX
    want = frozenset(i for i, (_, shed) in enumerate(offers) if shed)
    assert shed_seqs(ours_dir) == shed_seqs(theirs_dir) == want
    assert jax.control.shed_seqs(ours_dir) == want
    assert [a for _, a, _ in journal.Journal(ours_dir).read() if a[0] == "decision"] == \
        [a for _, a, _ in journal.Journal(theirs_dir).read() if a[0] == "decision"]


def test_control_options_checks_match_jax(jax):
    bad = [dict(decision_every=0), dict(window_short=8, window_long=4), dict(min_hold_ticks=0),
           dict(escalate_occupancy=0.3, deescalate_occupancy=0.5), dict(dwell_raise_occupancy=0.1,
           dwell_lower_occupancy=0.2), dict(coalesce_min=0), dict(timed_block_timeout_s=-1.0),
           dict(linger_step_ms=0.0)]
    for kwargs in bad:
        with pytest.raises(ServeError) as ours:
            ControlOptions(**kwargs)
        with pytest.raises(jax.exc.ServeError) as theirs:
            jax.serve.ControlOptions(**kwargs)
        assert str(ours.value) == str(theirs.value)


def test_control_env_knobs(monkeypatch):
    monkeypatch.setenv("TM_TPU_SERVE_CONTROL_DECISION_EVERY", "3")
    monkeypatch.setenv("TM_TPU_SERVE_CONTROL_MIN_HOLD_TICKS", "9")
    monkeypatch.setenv("TM_TPU_SERVE_CONTROL_TIMED_TIMEOUT_S", "0.125")
    monkeypatch.setenv("TM_TPU_SERVE_CONTROL_WINDOW_SHORT", "-4")
    with pytest.warns(UserWarning, match="out-of-range env TM_TPU_SERVE_CONTROL_WINDOW_SHORT"):
        opts = control_options_from_env()
    assert (opts.decision_every, opts.min_hold_ticks, opts.timed_block_timeout_s, opts.window_short) == (3, 9, 0.125, 16)


def test_unattached_engine_raises():
    with pytest.raises(ServeError, match="not attached"):
        ServeController().linger_ms(_StubEngine(ServeOptions()))


def test_park_budget_exhaustion_sheds_and_replays_bit_identical(tmp_path):
    wal = str(tmp_path / "wal")
    m = port.SumMetric(**CPU)
    eng = m.serve(ServeOptions(max_inflight=2, on_full="block", queue_timeout_s=0.02), journal=journal.Journal(wal))
    ctrl = ServeController(ControlOptions(**_fast(window_short=2, window_long=4, min_hold_ticks=2)))
    ctrl.attach(eng)
    eng.pause()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tickets = [m.update_async(np.asarray([float(i)], np.float32)) for i in range(8)]
    eng.resume()
    eng.quiesce()
    shed = [t for t in tickets if t.shed]
    assert shed and all(t.done() for t in tickets)
    assert len(shed_seqs(wal + CONTROL_DIR_SUFFIX)) == len(shed)
    twin = port.SumMetric(**CPU)
    out = adaptive_recover(twin, wal)
    assert out["shed_skipped"] == len(shed)
    assert float(twin.compute()) == float(m.compute())


def test_block_without_controller_still_raises():
    m = port.SumMetric(**CPU)
    eng = m.serve(ServeOptions(max_inflight=2, on_full="block", queue_timeout_s=0.02))
    eng.pause()
    try:
        with pytest.raises(BackpressureError, match="queue_timeout_s=0.02s"):
            for i in range(5):
                m.update_async(np.asarray([float(i)], np.float32))
    finally:
        eng.resume()
        eng.quiesce()


@pytest.mark.parametrize("control", ["true", "instance"])
def test_serve_control_attaches(control):
    ctrl = ServeController(ControlOptions(**_fast())) if control == "instance" else True
    m = port.SumMetric(**CPU)
    eng = m.serve(ServeOptions(max_inflight=4), control=ctrl)
    assert isinstance(eng._control, ServeController) and (control == "true" or eng._control is ctrl)
    m.update_async(np.asarray([2.0], np.float32))
    assert float(m.compute()) == 2.0 and eng._control.channel_report(eng)["tick"] == 1


def _square_wave(metric, engine, n=30, period=5):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(n):
            if (i // period) % 2 == 1:
                engine.pause()
            else:
                engine.resume()
            metric.update_async(np.full((3,), float(i % 7), np.float32))
        engine.resume()
        engine.quiesce()


def test_a_jax_served_wal_recovers_into_the_port(jax, tmp_path):
    """A WAL and decision journal that a JAX served metric wrote under its controller replay here, less the
    journaled sheds, to the JAX metric's live value; without the skips, to JAX's own ``recover``."""
    wal = str(tmp_path / "jax-wal")
    theirs = jax.top.SumMetric()
    eng = theirs.serve(jax.serve.ServeOptions(max_inflight=2, on_full="block", queue_timeout_s=0.01, coalesce=2),
                       journal=jax.journal.Journal(wal))
    jax.serve.ServeController(jax.serve.ControlOptions(**_fast(window_short=2, window_long=4,
                                                               min_hold_ticks=2))).attach(eng)
    _square_wave(theirs, eng)
    assert eng.stats()["shed"] > 0
    ours = port.SumMetric(**CPU)
    out = adaptive_recover(ours, wal)
    assert out["shed_skipped"] == eng.stats()["shed"]
    assert float(ours.compute()) == float(np.asarray(theirs.compute()))
    everything, jax_everything = port.SumMetric(**CPU), jax.top.SumMetric()
    journal.recover(everything, wal)
    jax.journal.recover(jax_everything, wal)
    assert float(everything.compute()) == float(np.asarray(jax_everything.compute()))


def test_adaptive_recover_without_control_journal(tmp_path):
    wal = str(tmp_path / "plain-wal")
    m = port.SumMetric(**CPU)
    m.serve(ServeOptions(max_inflight=8), journal=journal.Journal(wal))
    for i in range(4):
        m.update_async(np.asarray([float(i)], np.float32))
    twin = port.SumMetric(**CPU)
    assert adaptive_recover(twin, wal)["shed_skipped"] == 0
    assert float(twin.compute()) == float(m.compute())


def test_shared_drain_two_engines_one_thread_bit_identical():
    sd = SharedDrain()
    ms, refs = [port.SumMetric(**CPU), port.MeanMetric(**CPU)], [port.SumMetric(**CPU), port.MeanMetric(**CPU)]
    engines, order = [], []
    try:
        for m in ms:
            eng = sd.attach(m.serve(ServeOptions(max_inflight=8)))
            real = eng._apply_window

            def recorded(items, real=real, name=type(m).__name__):
                order.append((name, [it[0].seq for it in items]))
                return real(items)

            eng._apply_window = recorded
            engines.append(eng)
        rng = np.random.RandomState(7)
        for _ in range(20):
            b = rng.randint(0, 9, 4).astype(np.float32)
            for m, r in zip(ms, refs):
                m.update_async(b)
                r.update(b)
        for m, r, eng in zip(ms, refs, engines):
            assert m.compute().numpy().tobytes() == r.compute().numpy().tobytes()
            assert eng._thread is None  # the engine's own drain thread never started
        for name in ("SumMetric", "MeanMetric"):
            seqs = [s for n, window in order if n == name for s in window]
            assert seqs == list(range(20))  # FIFO per engine
    finally:
        sd.close()


def test_shared_drain_restart_latch_and_detach():
    sd = SharedDrain()
    m = port.SumMetric(**CPU)
    eng = sd.attach(m.serve(ServeOptions(max_inflight=8)))
    try:
        m.update_async(np.asarray([1.0], np.float32))
        assert float(m.compute()) == 1.0
        sd.close()
        m.update_async(np.asarray([2.0], np.float32))  # the enqueue revives the thread
        assert float(m.compute()) == 3.0 and sd.restarts >= 1
    finally:
        sd.close()
    sd2 = SharedDrain()
    m2 = port.SumMetric(**CPU)
    eng2 = sd2.attach(m2.serve(ServeOptions(max_inflight=8)))
    sd2.detach(eng2)
    sd2.close()
    assert eng2._drain_owner is None
    m2.update_async(np.asarray([5.0], np.float32))
    assert float(m2.compute()) == 5.0


class _StubDetector(DriftDetector):
    def __init__(self):
        self.value = 0.0

    def score(self):
        return self.value


def test_drift_snapshotter_captures_pre_shift_and_at_alarm(tmp_path):
    det = _StubDetector()
    spec = DriftSpec(name="t-ctl-snap", detector=det, threshold=0.5, objective=0.9, windows=((5.0, 1.0),))
    m = port.SumMetric(**CPU)
    m.update(np.asarray([1.0, 2.0, 3.0], np.float32))
    snap = DriftSnapshotter(m, DriftMonitor([spec]), str(tmp_path / "drift"))
    now = 1000.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(10):
            snap.poll(now=now)
            now += 1.0
        assert snap.captured == []
        det.value = 5.0
        m.update(np.asarray([10.0], np.float32))
        for _ in range(30):
            snap.poll(now=now)
            now += 1.0
    assert len(snap.captured) == 1
    rec = snap.captured[0]
    assert rec["name"] == "t-ctl-snap" and rec["incident"]
    before, after = port.SumMetric(**CPU), port.SumMetric(**CPU)
    ckpt.restore_metric(before, ckpt.load_snapshot(rec["paths"]["pre_shift"]))
    ckpt.restore_metric(after, ckpt.load_snapshot(rec["paths"]["at_alarm"]))
    assert float(before.compute()) == 6.0 and float(after.compute()) == 16.0
    assert rec["bundle"] is not None and os.path.exists(rec["bundle"])
    assert obs.telemetry.counter("control.drift_snapshots").value >= 1


def test_jittered_wait_bounds_and_seeded_determinism(monkeypatch):
    monkeypatch.setenv("TM_TPU_CHAOS_SEED", "1234")
    seqs = []
    for _ in range(2):
        reset_backoff_rng()
        prev, seq = _BLOCK_WAIT_MIN_S, []
        for _ in range(64):
            prev = _jittered_wait(prev)
            assert _BLOCK_WAIT_MIN_S <= prev <= _BLOCK_WAIT_MAX_S
            seq.append(prev)
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    reset_backoff_rng()
