"""The port's async ingestion engine (``serve/``) against the JAX package's.

- Served values equal synchronous values and JAX's for the same batches: ``SumMetric``, ``CatMetric``,
  ``MulticlassAccuracy``, a ``KeyedMetric`` and a ``MetricCollection``.
- Tickets and their generation (this package's generation counts graph steps: it moves on the emulated graph tier
  and stays on the eager one).
- Each ``on_full`` mode's counts and messages against JAX's for the same held-drain sequence; the coalesced widths
  and ``stats()`` against JAX's for a held window of 1-40 batches.
- ``ServeOptions``' checks and the env knobs with JAX's messages; deepcopy and pickle drop the engine.
- The four serve injectors of ``robust/chaos.py``; the generation fence.
- The quiesce rules of the JAX package's ``tests/unittests/serve/test_quiesce_guards.py``, with a live name-keyed
  gather over two replicas in place of its ``SimWorld``, and every host access path quiescing the window.
"""
from __future__ import annotations

import copy
import pickle
import threading
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as port
from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassF1Score
from torchmetrics_tpu_torch.obs import bundle
from torchmetrics_tpu_torch.ops import dispatch
from torchmetrics_tpu_torch.robust.chaos import DrainThreadDeath, PreemptMidOverlap, QueueOverflow, StagingTransferFailure
from torchmetrics_tpu_torch.robust.journal import Journal, recover
from torchmetrics_tpu_torch.serve import IngestEngine, IngestTicket, ServeOptions, serve_options_from_env
from torchmetrics_tpu_torch.utils.exceptions import (
    BackpressureError,
    ServeError,
    SnapshotError,
    TorchMetricsUserError,
)

CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu as jt
    from torchmetrics_tpu import serve as jserve
    from torchmetrics_tpu.utils import exceptions as jexc
    from torchmetrics_tpu.utils.prints import reset_warning_cache

    return SimpleNamespace(top=jt, serve=jserve, exc=jexc, reset_warning_cache=reset_warning_cache)


@pytest.fixture(autouse=True)
def _bundles_in_tmp(tmp_path):
    with bundle.capture_dir(str(tmp_path / "bundles")):
        yield


def _b(v: float, size: int = 4):
    return np.full((size,), v, np.float32)


def _batches(n=8, size=4, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 9, size).astype(np.float32),) for _ in range(n)]


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_bits(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _labels(n=6, rows=12, classes=3, seed=5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(rows, classes).astype(np.float32), rng.randint(0, classes, rows).astype(np.int64))
            for _ in range(n)]


def _keyed(n=6, rows=10, keys=5, seed=7):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, keys, rows).astype(np.int64), rng.randn(rows).astype(np.float32)) for _ in range(n)]


CASES = {
    "SumMetric": (lambda top, kw: top.SumMetric(**kw), lambda: _batches()),
    "CatMetric": (lambda top, kw: top.CatMetric(**kw), lambda: _batches()),
    "MulticlassAccuracy": (lambda top, kw: top.classification.MulticlassAccuracy(num_classes=3, **kw), _labels),
    "KeyedMetric": (lambda top, kw: top.KeyedMetric(top.SumMetric(**kw), 5), _keyed),
    "MetricCollection": (lambda top, kw: top.MetricCollection([top.classification.MulticlassAccuracy(num_classes=3, **kw),
                                                                top.classification.MulticlassF1Score(num_classes=3, **kw)]),
                         _labels),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_async_equals_sync_and_jax(jax, case):
    make, data = CASES[case]
    batches = data()
    served, ref = make(port, CPU), make(port, CPU)
    tickets = [served.update_async(*b) for b in batches]
    for b in batches:
        ref.update(*b)
    assert all(isinstance(t, IngestTicket) for t in tickets)
    assert _same_bits(served.compute(), ref.compute())
    theirs = make(jax.top, {})
    for b in batches:
        theirs.update(*b)
    want = theirs.compute()
    if isinstance(want, dict):
        for k, v in want.items():
            np.testing.assert_allclose(_np(served.compute())[k], np.asarray(v), rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_allclose(_np(served.compute()), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert all(t.done() and t.error is None and not t.shed for t in tickets)


def test_tickets_and_their_generation(monkeypatch):
    m = port.SumMetric(**CPU)
    t = m.update_async(_b(1.0))
    assert t.result(timeout=2.0) == 0 == m.state_generation  # the eager tier moves no generation
    assert t.done() and t.error is None and not t.shed and "done" in repr(t)
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    g = port.SumMetric(**CPU)
    g.fast_update = True
    eng = g.serve(ServeOptions(max_inflight=64))
    gens = [g.update_async(_b(float(i))).result(timeout=2.0) for i in range(3)]
    assert gens == [1, 2, 3] and g.state_generation == 3  # one graph step a window
    eng.pause()
    pending = [g.update_async(_b(1.0)) for _ in range(4)]
    assert not pending[0].done() and "pending" in repr(pending[0])
    eng.resume()
    eng.quiesce()
    assert {p.generation for p in pending} == {4}  # the four coalesced into one update_batches step


def _held_drain(top, options_cls, exc_mod, kw, opts, offered):
    """Enqueue ``offered`` batches against a held drain; returns (stats, error text or None, tickets shed)."""
    m = top.SumMetric(**kw)
    eng = m.serve(options_cls(**opts))
    m.update_async(_b(0.0))
    eng.quiesce()
    eng.pause()
    err, tickets = None, []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            for i in range(offered):
                tickets.append(m.update_async(_b(float(i))))
        except exc_mod.BackpressureError as e:
            err = str(e)
        eng.resume()
        eng.quiesce()
    return eng.stats(), err, [t.shed for t in tickets], float(np.asarray(_np(m.compute())))


@pytest.mark.parametrize("on_full", ["shed", "raise", "block"])
def test_on_full_modes_match_jax(jax, on_full):
    opts = {"max_inflight": 3, "on_full": on_full, "queue_timeout_s": 0.2}
    import torchmetrics_tpu_torch.utils.exceptions as pexc

    ours = _held_drain(port, ServeOptions, pexc, CPU, opts, 7)
    theirs = _held_drain(jax.top, jax.serve.ServeOptions, jax.exc, {}, opts, 7)
    assert ours == theirs
    stats, err, shed, _ = ours
    if on_full == "shed":
        assert sum(shed) == 4 and stats["shed"] == 4 and err is None
        assert stats["committed"] + stats["shed"] == stats["enqueued"] + stats["shed"] == 8
    else:
        assert err is not None and stats["shed"] == 0 and stats["committed"] == 4
        assert ("on_full='raise'" in err) if on_full == "raise" else ("queue_timeout_s=0.2s" in err)


def _widths(engine, out):
    real = engine._apply_window

    def recorded(items):
        out.append(len(items))
        return real(items)

    engine._apply_window = recorded


def test_coalesced_widths_and_stats_match_jax_for_held_windows_of_1_to_40(jax):
    ours_m, theirs_m = port.SumMetric(**CPU), jax.top.SumMetric()
    ours_e = ours_m.serve(ServeOptions(max_inflight=64, coalesce=16))
    theirs_e = theirs_m.serve(jax.serve.ServeOptions(max_inflight=64, coalesce=16))
    ours_w, theirs_w = [], []
    _widths(ours_e, ours_w)
    _widths(theirs_e, theirs_w)
    for n in range(1, 41):
        for m, e in ((ours_m, ours_e), (theirs_m, theirs_e)):
            e.pause()
            for i in range(n):
                m.update_async(_b(float(i % 7)))
            e.resume()
            e.quiesce()
        assert ours_w == theirs_w, n
        assert ours_e.stats() == theirs_e.stats(), n
        assert float(ours_m.compute()) == float(np.asarray(theirs_m.compute()))
        ours_w.clear()
        theirs_w.clear()
    assert ours_e.stats()["committed"] == 820


def test_shape_change_splits_the_window():
    m, ref = port.SumMetric(**CPU), port.SumMetric(**CPU)
    eng = m.serve(ServeOptions(max_inflight=64, coalesce=16))
    seen = []
    _widths(eng, seen)
    eng.pause()
    for size in (4, 4, 6, 4):
        m.update_async(_b(1.0, size))
        ref.update(_b(1.0, size))
    eng.resume()
    eng.quiesce()
    assert seen == [2, 1, 1] and float(m.compute()) == float(ref.compute()) == 18.0


def test_linger_still_quiesces_immediately():
    m = port.SumMetric(**CPU)
    m.serve(ServeOptions(max_inflight=64, linger_ms=500.0))
    m.update_async(_b(0.75))
    assert float(m.compute()) == 3.0


INVALID_OPTIONS = [
    {"max_inflight": 0}, {"coalesce": 0}, {"linger_ms": -1.0}, {"on_full": "drop"}, {"queue_timeout_s": -1.0},
    {"staging_slots": 0},
]


@pytest.mark.parametrize("kwargs", INVALID_OPTIONS, ids=lambda k: next(iter(k)))
def test_serve_options_checks_match_jax(jax, kwargs):
    with pytest.raises(ServeError) as ours:
        ServeOptions(**kwargs)
    with pytest.raises(jax.exc.ServeError) as theirs:
        jax.serve.ServeOptions(**kwargs)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("env", [
    {"TM_TPU_SERVE_MAX_INFLIGHT": "8", "TM_TPU_SERVE_ON_FULL": "SHED", "TM_TPU_SERVE_QUEUE_TIMEOUT_S": "1.5"},
    {"TM_TPU_SERVE_MAX_INFLIGHT": "lots", "TM_TPU_SERVE_ON_FULL": "explode", "TM_TPU_SERVE_STAGING_SLOTS": "0",
     "TM_TPU_SERVE_COALESCE": "4", "TM_TPU_SERVE_LINGER_MS": "-2"},
], ids=["valid", "malformed"])
def test_env_options_match_jax(jax, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jax.reset_warning_cache()
    with warnings.catch_warnings(record=True) as ours_w:
        warnings.simplefilter("always")
        ours = serve_options_from_env()
    with warnings.catch_warnings(record=True) as theirs_w:
        warnings.simplefilter("always")
        theirs = jax.serve.serve_options_from_env()
    assert {f: getattr(ours, f) for f in ours.__dataclass_fields__} == \
        {f: getattr(theirs, f) for f in theirs.__dataclass_fields__}
    assert sorted(str(w.message) for w in ours_w) == sorted(str(w.message) for w in theirs_w)
    m = port.SumMetric(**CPU)
    assert m.serve().options == ours  # the default of an unconfigured metric


def test_serve_reconfigure_rejected():
    m = port.SumMetric(**CPU)
    eng = m.serve(ServeOptions(max_inflight=8))
    assert m.serve() is eng and m.serve(ServeOptions(max_inflight=8)) is eng
    with pytest.raises(TorchMetricsUserError, match="cannot re-configure"):
        m.serve(ServeOptions(max_inflight=9))
    mc = port.MetricCollection([port.SumMetric(**CPU)])
    assert isinstance(mc.serve(), IngestEngine)
    with pytest.raises(TorchMetricsUserError, match="collection's ingestion engine"):
        mc.serve(ServeOptions(max_inflight=3))


@pytest.mark.parametrize("kind", ["metric", "collection"])
def test_deepcopy_and_pickle_drop_the_engine(kind):
    m = port.SumMetric(**CPU) if kind == "metric" else port.MetricCollection([port.SumMetric(**CPU)])
    eng = m.serve(ServeOptions(max_inflight=64))
    eng.pause()
    m.update_async(_b(2.0))
    eng.resume()
    clone = copy.deepcopy(m)  # quiesces first: the copy holds the async batch
    back = pickle.loads(pickle.dumps(m))
    for other in (clone, back):
        assert other.__dict__.get("_serve") is None and other._serve is None
        value = other.compute()
        assert float(value if kind == "metric" else value["SumMetric"]) == 8.0
    assert m._serve is eng


def test_drain_thread_death_restarts_bit_identical():
    m, ref = port.SumMetric(**CPU), port.SumMetric(**CPU)
    eng = m.serve(ServeOptions(max_inflight=64))
    with pytest.warns(UserWarning, match="drain thread died; restarting"):
        for i, (b,) in enumerate(_batches(6)):
            ref.update(b)
            if i == 3:
                with DrainThreadDeath() as inj:
                    m.update_async(b)
                    eng.quiesce()
                assert inj.fired == 1
            else:
                m.update_async(b)
        m.compute()
    assert eng.stats()["drain_restarts"] == 1
    assert _same_bits(m.compute(), ref.compute())


def test_drain_death_without_restart_is_a_serve_error():
    m = port.SumMetric(**CPU)
    eng = m.serve(ServeOptions(max_inflight=64, restart_drain=False))
    with DrainThreadDeath():
        m.update_async(_b(1.0))
        eng._thread.join(timeout=2.0)
    with pytest.raises(ServeError, match="restart_drain is off"):
        eng.quiesce()


def test_staging_failure_degrades_not_drops():
    from torchmetrics_tpu_torch import obs

    m, ref = port.SumMetric(**CPU), port.SumMetric(**CPU)
    fb0 = obs.telemetry.counter("serve.staging_fallbacks").value
    with pytest.warns(UserWarning, match="staging transfer failed"), StagingTransferFailure(fail_calls=2) as inj:
        for (b,) in _batches(5):
            m.update_async(b)
            ref.update(b)
        m.serve().quiesce()
    assert inj.fired == 2
    assert obs.telemetry.counter("serve.staging_fallbacks").value - fb0 == 2
    assert _same_bits(m.compute(), ref.compute())


def test_queue_overflow_turns_into_backpressure():
    m = port.SumMetric(**CPU)
    eng = m.serve(ServeOptions(max_inflight=2, on_full="raise"))
    with QueueOverflow(eng) as inj:
        m.update_async(_b(1.0))
        m.update_async(_b(1.0))
        with pytest.raises(BackpressureError, match="on_full='raise'"):
            m.update_async(_b(1.0))
        assert eng.inflight == 2
    assert inj.fired == 1 and float(m.compute()) == 8.0


def test_apply_failure_surfaces_at_quiesce():
    m = MulticlassAccuracy(num_classes=3, validate_args=False, **CPU)
    m.update_async(np.asarray([[0.7, 0.2, 0.1]], np.float32), np.asarray([0], np.int32))
    m.serve().quiesce()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = m.update_async(np.asarray(["bogus"]), np.asarray([0], np.int32))
    with pytest.raises(ServeError, match="failed to apply"):
        m.serve().quiesce()
    assert t.error is not None
    with pytest.raises(type(t.error)):
        t.result(timeout=1.0)
    assert float(m.compute()) == 1.0


def test_preempt_mid_overlap_journal_recovery(tmp_path):
    batches = _batches(8)
    m = port.SumMetric(**CPU)
    eng = m.serve(ServeOptions(max_inflight=64), journal=Journal(tmp_path / "wal"))
    for (b,) in batches[:3]:
        m.update_async(b)
    eng.quiesce()
    eng.pause()
    for (b,) in batches[3:6]:
        m.update_async(b)
    assert PreemptMidOverlap().strike(m) == 3
    with pytest.raises(ServeError, match="abandoned"):
        m.update_async(batches[6][0])
    fresh = port.SumMetric(**CPU)
    assert recover(fresh, tmp_path / "wal")["replayed"] == 6
    for (b,) in batches[6:]:
        fresh.update(b)
    ref = port.SumMetric(**CPU)
    for (b,) in batches:
        ref.update(b)
    assert _same_bits(fresh.compute(), ref.compute())
    with pytest.raises(ValueError, match="live serve engine"):
        PreemptMidOverlap().strike(port.SumMetric(**CPU))


def test_generation_fence_detects_mid_window_mutation():
    m = port.SumMetric(**CPU)
    eng = m.serve(ServeOptions(max_inflight=64))
    m.update_async(_b(1.0)).result(timeout=2.0)
    eng.pause()
    m.update_async(_b(1.0))
    m._state.bump_generation()  # a foreign step moves the generation behind the non-empty window
    fb0 = eng.stats()["fence_breaks"]
    with pytest.warns(UserWarning, match="generation fence broke"):
        eng.resume()
        eng.quiesce()
    assert eng.stats()["fence_breaks"] == fb0 + 1
    m.reset()  # a quiesce disarms the fence: post-quiesce mutations are legitimate
    m.update_async(_b(1.0))
    eng.quiesce()
    assert eng.stats()["fence_breaks"] == fb0 + 1


def test_journaled_update_async_snapshots_on_its_cycle(tmp_path):
    m = port.SumMetric(**CPU)
    jm = m.journal(tmp_path / "wal", every_k=3)
    for (b,) in _batches(7):
        jm.update_async(b)
    assert jm.journal.pending == 1  # two snapshots taken, one record after them
    jm.close()
    back = port.SumMetric(**CPU)
    recover(back, tmp_path / "wal")
    assert _same_bits(back.compute(), m.compute())


def test_many_producers_keep_every_batch():
    m = port.SumMetric(**CPU)
    m.serve(ServeOptions(max_inflight=4, on_full="block", queue_timeout_s=2.0))

    def produce():
        for _ in range(25):
            m.update_async(_b(1.0))

    threads = [threading.Thread(target=produce) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert float(m.compute()) == 400.0 and m.serve().stats()["committed"] == 100


def test_staging_copies_into_slots_and_reuses_them():
    """On the CPU a staged leaf is a copy of the host array; a slot is pinned until released; with no free slot
    the host batch is handed through; non-array leaves pass untouched."""
    from torchmetrics_tpu_torch.serve.staging import StagingPipeline

    pipe = StagingPipeline(2, device="cpu")
    host = np.arange(6, dtype=np.float32)
    (a, label), kw, slot = pipe.stage((host, "tag"), {"k": np.ones(2, np.int32)})
    assert isinstance(a, torch.Tensor) and label == "tag" and kw["k"].dtype == torch.int32
    host[0] = 99.0
    assert float(a[0]) == 0.0  # the staged copy does not follow the host array
    _, _, second = pipe.stage((host,), {})
    (passed,), _, none = pipe.stage((host,), {})
    assert none is None and passed is host and pipe.in_use == 2
    pipe.release(slot)
    _, _, again = pipe.stage((host,), {})
    assert again == slot and {slot, second} == {0, 1}
    pipe.release(None)  # a skipped batch has no slot to release


# ------------------------------------------------------------------ the quiesce rules
def _live_gather(replicas):
    """A world of ``len(replicas)`` processes: a name-keyed gather reading every replica's state at call time."""

    def gather(value, group=None, name=None):
        return [rep._tensors[name] for rep in replicas]

    return gather


def test_update_async_raises_while_buffered_pending():
    m = port.SumMetric(**CPU)
    buf = m.buffered(4)
    buf.update(_b(1.0))
    with pytest.raises(TorchMetricsUserError, match="update_async.*pending"):
        m.update_async(_b(1.0))
    buf.flush()
    m.update_async(_b(2.0))
    assert float(m.compute()) == 4.0 + 8.0


def test_buffered_flush_quiesces_async_window_first():
    m, ref = port.SumMetric(**CPU), port.SumMetric(**CPU)
    eng = m.serve(ServeOptions(max_inflight=64))
    eng.pause()
    m.update_async(_b(1.0))
    ref.update(_b(1.0))
    eng.resume()
    buf = m.buffered(2)
    buf.update(_b(2.0))
    buf.update(_b(3.0))
    ref.update(_b(2.0))
    ref.update(_b(3.0))
    buf.flush()
    assert _same_bits(m.compute(), ref.compute())


def test_reset_quiesces_then_clears():
    m = port.SumMetric(**CPU)
    eng = m.serve(ServeOptions(max_inflight=64))
    eng.pause()
    for _ in range(3):
        m.update_async(_b(1.0))
    eng.resume()
    m.reset()
    assert eng.stats()["committed"] == 3 and m.update_count == 0
    m.update_async(_b(5.0))
    assert float(m.compute()) == 20.0


def test_snapshot_quiesces_exactly():
    m = port.SumMetric(**CPU)
    eng = m.serve(ServeOptions(max_inflight=64))
    eng.pause()
    m.update_async(_b(1.0))
    m.update_async(_b(2.0))
    eng.resume()
    blob = m.snapshot()
    fresh = port.SumMetric(**CPU)
    fresh.restore(blob)
    assert float(fresh.compute()) == 12.0


def test_mid_flight_snapshot_still_hard_error():
    m = port.SumMetric(**CPU)
    m.update(_b(1.0))
    m._state.inflight = True  # a graph step writing the state in place
    try:
        with pytest.raises(SnapshotError, match="mid-flight"):
            m.snapshot()
    finally:
        m._state.inflight = False


def test_world_consistent_stays_full_after_sheds():
    m, other = port.SumMetric(**CPU), port.SumMetric(**CPU)
    other.update(_b(1.0))
    m.dist_sync_fn = _live_gather([m, other])
    m.distributed_available_fn = lambda: True
    eng = m.serve(ServeOptions(max_inflight=1, on_full="shed"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with QueueOverflow(eng):
            tickets = [m.update_async(_b(1.0)) for _ in range(4)]
    assert sum(t.shed for t in tickets) == 3
    assert float(m.compute()) == 8.0  # the committed batch and the other replica's
    assert m.world_consistent == "full" and bool(m.world_consistent)
    assert eng.stats()["shed"] == 3


def test_sync_quiesces_window_first():
    m, other = port.SumMetric(**CPU), port.SumMetric(**CPU)
    m.dist_sync_fn = _live_gather([m, other])
    m.distributed_available_fn = lambda: True
    eng = m.serve(ServeOptions(max_inflight=64))
    eng.pause()
    m.update_async(_b(1.0))
    eng.resume()
    m.sync()
    assert float(m._state.tensors["sum_value"]) == 4.0
    m.unsync()


def test_update_and_forward_quiesce_first():
    m, ref = port.SumMetric(**CPU), port.SumMetric(**CPU)
    eng = m.serve(ServeOptions(max_inflight=64))
    eng.pause()
    m.update_async(_b(1.0))
    ref.update(_b(1.0))
    eng.resume()
    m.update(_b(2.0))
    ref.update(_b(2.0))
    m.forward(_b(3.0))
    ref.update(_b(3.0))
    assert _same_bits(m.compute(), ref.compute())


def _metric():
    m = port.SumMetric(**CPU)
    m.update(_b(1.0))
    return m


def _guarded():
    m = port.MeanMetric(nan_policy="warn", **CPU)
    m.update(_b(1.0))
    return m


def _collection():
    mc = port.MetricCollection([port.SumMetric(**CPU)])
    mc.update(_b(1.0))
    return mc


def _windowed():
    w = port.SumMetric(**CPU).windowed(3, advance_every=2)
    w.update(_b(1.0))
    return w


def _keyed_metric():
    k = port.KeyedMetric(port.SumMetric(**CPU), 4)
    k.update(np.array([0, 1]), np.ones(2, np.float32))
    return k


ACCESS_PATHS = {
    "metric_state": (_metric, lambda m: m.metric_state),
    "update": (_metric, lambda m: m.update(_b(1.0))),
    "update_batches": (_metric, lambda m: m.update_batches(np.stack([_b(1.0)] * 2))),
    "forward": (_metric, lambda m: m.forward(_b(1.0))),
    "compute": (_metric, lambda m: m.compute()),
    "reset": (_metric, lambda m: m.reset()),
    "sync": (_metric, lambda m: m.sync(dist_sync_fn=_live_gather([m]), distributed_available=lambda: True)),
    "state_dict": (_metric, lambda m: m.state_dict()),
    "load_state_dict": (_metric, lambda m: m.load_state_dict({}, strict=False)),
    "to": (_metric, lambda m: m.to("cpu")),
    "set_dtype": (_metric, lambda m: m.set_dtype(torch.float64)),
    "snapshot": (_metric, lambda m: m.snapshot()),
    "deepcopy": (_metric, lambda m: copy.deepcopy(m)),
    "pickle": (_metric, lambda m: pickle.dumps(m)),
    "nan_poison_count": (_guarded, lambda m: m.nan_poison_count),
    "collection.forward": (_collection, lambda m: m.forward(_b(1.0))),
    "collection.update": (_collection, lambda m: m.update(_b(1.0))),
    "collection.update_batches": (_collection, lambda m: m.update_batches(np.stack([_b(1.0)] * 2))),
    "collection.compute": (_collection, lambda m: m.compute()),
    "collection.reset": (_collection, lambda m: m.reset()),
    "collection.snapshot": (_collection, lambda m: m.snapshot()),
    "collection.deepcopy": (_collection, lambda m: copy.deepcopy(m)),
    "collection.pickle": (_collection, lambda m: pickle.dumps(m)),
    "windowed.window_values": (_windowed, lambda m: m.window_values()),
    "windowed.window_state": (_windowed, lambda m: m.window_state()),
    "keyed.compute_keys": (_keyed_metric, lambda m: m.compute(keys=[0, 1])),
}


@pytest.mark.parametrize("path", sorted(ACCESS_PATHS))
def test_every_host_access_path_quiesces(path):
    """Each host access path quiesces the window first (JAX ``metric.py:272-1876``, ``collections.py:103-871``,
    ``windowed.py:320-399``, ``keyed/engine.py:325``): the engine's quiesce is called by the access itself."""
    make, access = ACCESS_PATHS[path]
    m = make()
    eng = m.serve(ServeOptions(max_inflight=64))
    calls = []
    real = eng.quiesce

    def counted(timeout=None):
        calls.append(threading.current_thread().name)
        return real(timeout)

    eng.quiesce = counted
    access(m)
    assert calls, f"{path} did not quiesce the ingestion window"


# ------------------------------------------------------------------ on the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_collection(device, classes):
    mc = port.MetricCollection([MulticlassAccuracy(num_classes=classes, device=device),
                                MulticlassF1Score(num_classes=classes, average="macro", device=device)])
    for m in mc.values(copy_state=False):
        m.fast_update = True
    return mc


@pytest.mark.cuda
def test_compute_straight_after_quiesce_sees_every_commit_on_the_card():
    """Large staged batches: without the caller's stream waiting on the drain's stream at quiesce, a compute
    issued right after it could read counts the drain is still writing."""
    device = _card()
    rng = np.random.RandomState(0)
    classes, rows = 1000, 4000
    batches = [(rng.standard_normal((rows, classes)).astype(np.float32), rng.randint(0, classes, rows))
               for _ in range(24)]
    ref = _card_collection(device, classes)
    served = _card_collection(device, classes)
    eng = served.serve(ServeOptions(max_inflight=64, coalesce=8, staging_slots=2))
    for i, (p, t) in enumerate(batches):
        ref.update(p, t)
        served.update_async(p, t)
        if i % 3 == 2:
            eng.quiesce()
            got, want = served.compute(), ref.compute()
            assert all(_same_bits(got[k], want[k]) for k in want), i
    eng.close()


@pytest.mark.cuda
def test_drain_captures_new_widths_while_the_caller_stages():
    """No warm-up: the drain captures each new coalesced width while the caller keeps staging; no key latches
    broken, nothing falls back, the values are the synchronous run's."""
    from torchmetrics_tpu_torch import obs

    device = _card()
    rng = np.random.RandomState(1)
    batches = [(rng.standard_normal((2000, 50)).astype(np.float32), rng.randint(0, 50, 2000)) for _ in range(60)]
    ref = _card_collection(device, 50)
    served = _card_collection(device, 50)
    served.update(*batches[0])
    ref.update(*batches[0])
    eng = served.serve(ServeOptions(max_inflight=64, coalesce=16, linger_ms=1.0))
    fb0, f0 = obs.telemetry.counter("serve.staging_fallbacks").value, dispatch.STATS.n_fallbacks
    for p, t in batches[1:]:
        served.update_async(p, t)
        ref.update(p, t)
    eng.quiesce()
    leader = next(iter(served.values(copy_state=False)))
    assert not leader._graphs.broken and dispatch.STATS.n_fallbacks == f0
    assert obs.telemetry.counter("serve.staging_fallbacks").value == fb0
    got, want = served.compute(), ref.compute()
    assert all(_same_bits(got[k], want[k]) for k in want)
    eng.close()


@pytest.mark.cuda
def test_staging_slots_reuse_pinned_buffers_on_the_card():
    """A slot copies into page-locked buffers it keeps, then into fresh device tensors on the pipeline's stream;
    the next batch in that slot reuses the buffers once the slot's earlier copy is done."""
    from torchmetrics_tpu_torch.serve.staging import StagingPipeline

    device = _card()
    pipe = StagingPipeline(1, device=device)
    host = np.random.RandomState(2).rand(1000, 10).astype(np.float32)
    (a,), _, slot = pipe.stage((host,), {})
    buf = pipe._slots[slot].buffers[0]
    assert buf.is_pinned() and a.is_cuda
    torch.cuda.current_stream(device).wait_event(pipe.ready(slot))
    assert torch.equal(a.cpu(), torch.from_numpy(host))
    pipe.release(slot)
    (b,), _, again = pipe.stage((host * 2,), {})
    assert again == slot and pipe._slots[slot].buffers[0] is buf
    torch.cuda.current_stream(device).wait_event(pipe.ready(again))
    assert torch.equal(b.cpu(), torch.from_numpy(host * 2)) and torch.equal(a.cpu(), torch.from_numpy(host))
