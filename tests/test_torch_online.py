"""``Windowed`` and ``Ema`` of the port against a fresh twin and against the JAX package.

The cases follow ``tests/unittests/online/test_windowed.py``: for the named-reduction templates
(Sum, Mean, Max, Min over integer-valued float32, so every sum is exact) the window value is bit for
bit a fresh template fed exactly the window's batches, and JAX's window value, on every tier of the
port (the emulated graph tier, eager, ``buffered(4)``, ``update_batches``); exact boundaries, the
keyed template, the histogram window and the KLL ring (bit for bit the stacked merge of
per-sub-window sketches, and JAX's ring); the EMA closed form and its errors, the descriptors and
emission; and O2's and O3's template classes at a small size (sketched and binned AUROC,
multiclass accuracy). ``Ema(MulticlassAccuracy)`` holds its counts in float32, as JAX does, and
matches JAX within 1e-6. ``restore``, journals and serving wait for ROADMAP item 9.
"""
from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch import MetricCollection, obs
from torchmetrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from torchmetrics_tpu_torch.classification import BinaryAUROC, MulticlassAccuracy
from torchmetrics_tpu_torch.keyed import KeyedMetric
from torchmetrics_tpu_torch.online import DriftMonitor, Ema, Windowed, default_drift_specs
from torchmetrics_tpu_torch.online.windowed import ADVANCES_STATE, COUNT_STATE, SLOT_STATE
from torchmetrics_tpu_torch.ops import dispatch
from torchmetrics_tpu_torch.sketch import StreamingHistogram, StreamingQuantile
from torchmetrics_tpu_torch.sketch.kll import kll_merge_stacked
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

AGGREGATORS = ["SumMetric", "MeanMetric", "MaxMetric", "MinMetric"]
TIERS = ["graph", "eager", "buffered", "batches"]
WINDOW, EVERY = 3, 2
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu.aggregation as jagg
    import torchmetrics_tpu.classification as jcls
    import torchmetrics_tpu.online as jonline
    import torchmetrics_tpu.sketch as jsketch
    from torchmetrics_tpu.keyed import KeyedMetric as JKeyed

    return SimpleNamespace(agg=jagg, cls=jcls, online=jonline, sketch=jsketch, KeyedMetric=JKeyed)


def _on_tier(tier: str, monkeypatch) -> None:
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", tier != "eager")
    if tier == "eager":
        monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
    else:
        monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)


def _stream(seed: int, n_batches: int = 9, size: int = 6):
    rng = np.random.RandomState(seed)
    return [rng.randint(-6, 7, size=size).astype(np.float32) for _ in range(n_batches)]


def _window_batches(batches, window: int, every: int):
    """The batches a fresh twin must see: the last ``window`` sub-windows' worth (JAX's helper)."""
    advances = len(batches) // every
    return batches[max(0, advances - window + 1) * every:]


def _drive(m, batches, tier: str):
    if tier == "buffered":
        with m.buffered(4) as buf:
            for b in batches:
                buf.update(b)
    elif tier == "batches":
        m.update_batches(np.stack(batches))
    else:
        for b in batches:
            m.update(b)
    return m


def _bits(x) -> bytes:
    return (x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).tobytes()


# ------------------------------------------------------------------ windowed vs direct
@pytest.mark.parametrize("cls", AGGREGATORS)
@pytest.mark.parametrize("tier", TIERS)
def test_sliding_compute_bit_identical(jax, cls, tier, monkeypatch):
    _on_tier(tier, monkeypatch)
    batches = _stream(11)
    port_cls = {"SumMetric": SumMetric, "MeanMetric": MeanMetric, "MaxMetric": MaxMetric, "MinMetric": MinMetric}[cls]
    w = _drive(Windowed(port_cls(**CPU), WINDOW, advance_every=EVERY, emit=False), batches, tier)
    direct = port_cls(**CPU)
    for b in _window_batches(batches, WINDOW, EVERY):
        direct.update(b)
    theirs = jax.online.Windowed(getattr(jax.agg, cls)(), WINDOW, advance_every=EVERY, emit=False)
    for b in batches:
        theirs.update(b)
    assert _bits(w.compute()) == _bits(direct.compute()) == _bits(theirs.compute())
    assert w.windows_advanced == len(batches) // EVERY
    for name in theirs._state.tensors:  # the ring and its bookkeeping, JAX's bits
        assert _bits(w.metric_state[name]) == _bits(theirs.metric_state[name]), name
    if tier == "graph":
        assert w.telemetry["traces"] == {"update": 1} and w.telemetry["dispatches"] == len(batches) + 1


@pytest.mark.parametrize("boundary", [EVERY, 2 * EVERY, WINDOW * EVERY])
def test_exact_boundary_drops_oldest(boundary):
    batches = _stream(3, n_batches=boundary)
    w = _drive(Windowed(SumMetric(**CPU), WINDOW, advance_every=EVERY, emit=False), batches, "graph")
    direct = SumMetric(**CPU)
    for b in _window_batches(batches, WINDOW, EVERY):
        direct.update(b)
    assert float(w.compute()) == float(direct.compute())


@pytest.mark.parametrize("tier", ["graph", "eager"])
def test_keyed_template_window(jax, tier, monkeypatch):
    _on_tier(tier, monkeypatch)
    rng = np.random.RandomState(3)
    batches = [(rng.randint(0, 5, size=7).astype(np.int32), rng.randint(0, 9, size=7).astype(np.float32)) for _ in range(8)]
    w = Windowed(KeyedMetric(SumMetric, 5, **CPU), WINDOW, advance_every=EVERY, emit=False)
    theirs = jax.online.Windowed(jax.KeyedMetric(jax.agg.SumMetric, 5), WINDOW, advance_every=EVERY, emit=False)
    for b in batches:
        w.update(*b)
        theirs.update(*b)
    direct = KeyedMetric(SumMetric, 5, **CPU)
    for b in _window_batches(batches, WINDOW, EVERY):
        direct.update(*b)
    assert _bits(w.compute()) == _bits(direct.compute()) == _bits(theirs.compute())


@pytest.mark.parametrize("tier", ["graph", "eager"])
def test_histogram_window_bit_identical_to_direct(jax, tier, monkeypatch):
    _on_tier(tier, monkeypatch)
    batches = [np.random.RandomState(s).uniform(0, 1, 64).astype(np.float32) for s in range(9)]
    w = Windowed(StreamingHistogram(bins=16, **CPU), WINDOW, advance_every=EVERY, emit=False)
    theirs = jax.online.Windowed(jax.sketch.StreamingHistogram(bins=16), WINDOW, advance_every=EVERY, emit=False)
    for b in batches:
        w.update(b)
        theirs.update(b)
    direct = StreamingHistogram(bins=16, **CPU)
    for b in _window_batches(batches, WINDOW, EVERY):
        direct.update(b)
    assert _bits(w.compute()) == _bits(direct.compute()) == _bits(theirs.compute())


KLL_WINDOW = dict(q=0.5, capacity=32, levels=12)


@pytest.fixture(scope="module")
def jax_kll_window(jax):
    """JAX's ring over the KLL test's batches, built once for both tiers: its ring state, merged
    window state and value."""
    batches = [np.random.RandomState(s).normal(0, 1, 64).astype(np.float32) for s in range(9)]
    theirs = jax.online.Windowed(jax.sketch.StreamingQuantile(**KLL_WINDOW), WINDOW, advance_every=EVERY, emit=False)
    for b in batches:
        theirs.update(b)
    return batches, _bits(theirs.metric_state["sketch"]), _bits(theirs.window_state()["sketch"]), _bits(theirs.compute())


@pytest.mark.parametrize("tier", ["graph", "eager"])
def test_kll_window_bit_identical_to_subwindow_merge(jax_kll_window, tier, monkeypatch):
    """The ring's merged sketch is the stacked merge of per-sub-window sketches, and JAX's ring."""
    _on_tier(tier, monkeypatch)
    kw = KLL_WINDOW
    batches, their_ring, their_window, their_value = jax_kll_window
    w = Windowed(StreamingQuantile(**kw, **CPU), WINDOW, advance_every=EVERY, emit=False)
    for b in batches:
        w.update(b)
    assert _bits(w.metric_state["sketch"]) == their_ring
    live = _window_batches(batches, WINDOW, EVERY)
    states = []
    for i in range(0, len(live), EVERY):
        m = StreamingQuantile(**kw, **CPU)
        for b in live[i:i + EVERY]:
            m.update(b)
        states.append(m.metric_state["sketch"])
    while len(states) < WINDOW:
        states.append(StreamingQuantile(**kw, **CPU).metric_state["sketch"])
    merged = kll_merge_stacked(torch.stack(states[:WINDOW]))
    window_state = w.window_state()
    assert _bits(window_state["sketch"]) == _bits(merged) == their_window
    assert window_state["sketch"] is not w._tensors["sketch"]
    direct = StreamingQuantile(**kw, **CPU)
    for b in live:
        direct.update(b)
    assert abs(float(w.compute()) - float(direct.compute())) <= 0.5
    assert _bits(w.compute()) == their_value


# ------------------------------------------------------------------ EMA
def test_closed_form_sum():
    decay, vals = 0.75, [3.0, -1.0, 4.0, 2.0, 5.0]
    m = Ema(SumMetric(**CPU), decay=decay)
    for v in vals:
        m.update(np.asarray([v], np.float32))
    expected = np.float32(0.0)
    for i, v in enumerate(vals):
        expected = np.float32(expected + np.float32(decay) ** np.float32(len(vals) - 1 - i) * np.float32(v))
    assert abs(float(m.compute()) - float(expected)) < 1e-5


@pytest.mark.parametrize("tier", ["graph", "eager"])
def test_decay_one_is_plain_metric_and_jax_s(jax, tier, monkeypatch):
    _on_tier(tier, monkeypatch)
    batches = _stream(5)
    m, ref, theirs = Ema(MeanMetric(**CPU), decay=1.0), MeanMetric(**CPU), jax.online.Ema(jax.agg.MeanMetric(), decay=0.9)
    decayed = Ema(MeanMetric(**CPU), decay=0.9)
    for b in batches:
        m.update(b)
        ref.update(b)
        decayed.update(b)
        theirs.update(b)
    assert _bits(m.compute()) == _bits(ref.compute())
    assert abs(float(decayed.compute()) - float(theirs.compute())) <= 1e-6


def test_ema_errors():
    with pytest.raises(TorchMetricsUserError, match="sum-reduced"):
        Ema(MaxMetric(**CPU), decay=0.9)
    with pytest.raises(TorchMetricsUserError, match="no per-batch forward"):
        Ema(SumMetric(**CPU), decay=0.9)(np.asarray([1.0], np.float32))
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="decay"):
            Ema(SumMetric(**CPU), decay=bad)
    with pytest.raises(ValueError, match="emit_every"):
        Ema(SumMetric(**CPU), emit_every=0)


@pytest.mark.parametrize("tier", ["graph", "eager"])
def test_ema_of_multiclass_accuracy_is_float32_and_jax_s(jax, tier, monkeypatch):
    """The port's template counts in int64; Ema holds them in float32, as JAX decays them, so the
    decayed counts keep their fractions; value and counts within 1e-6 of JAX's."""
    _on_tier(tier, monkeypatch)
    rng = np.random.RandomState(63)
    m = Ema(MulticlassAccuracy(num_classes=7, **CPU), decay=0.99)
    theirs = jax.online.Ema(jax.cls.MulticlassAccuracy(num_classes=7), decay=0.99)
    for _ in range(6):
        preds, target = rng.randint(0, 7, 40).astype(np.int32), rng.randint(0, 7, 40).astype(np.int32)
        m.update(preds, target)
        theirs.update(preds, target)
    for name in ("tp", "fp", "tn", "fn"):
        ours = m.metric_state[name]
        assert ours.dtype == torch.float32 and m.template.metric_state[name].dtype == torch.int64
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs.metric_state[name]), rtol=1e-6, atol=1e-6)
        assert np.any(ours.numpy() != np.round(ours.numpy())), name  # nothing truncated
    assert abs(float(m.compute()) - float(theirs.compute())) <= 1e-6


# ------------------------------------------------------------------ edges
def test_never_advanced_equals_plain():
    w, ref = Windowed(SumMetric(**CPU), WINDOW, advance_every=None, emit=False), SumMetric(**CPU)
    for b in _stream(2, n_batches=3):
        w.update(b)
        ref.update(b)
    assert float(w.compute()) == float(ref.compute())


def test_empty_window_and_window_one():
    w = Windowed(MeanMetric(**CPU), WINDOW, advance_every=EVERY, emit=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert float(w.compute()) == 0.0
    w = Windowed(SumMetric(**CPU), 1, advance_every=2, emit=False)
    for v in (1.0, 2.0, 4.0, 8.0, 16.0):
        w.update(np.asarray([v], np.float32))
    assert float(w.compute()) == 16.0


@pytest.mark.parametrize("tier", ["graph", "eager"])
def test_manual_advance(tier, monkeypatch):
    _on_tier(tier, monkeypatch)
    w = Windowed(SumMetric(**CPU), 2, advance_every=None, emit=False)
    w.update(np.asarray([3.0], np.float32))
    w.advance()
    w.update(np.asarray([5.0], np.float32))
    assert float(w.compute()) == 8.0 and w.windows_advanced == 1
    w.advance()
    w.update(np.asarray([7.0], np.float32))
    assert float(w.compute()) == 12.0
    if tier == "graph":
        assert w.telemetry["traces"] == {"update": 1, "window_advance": 1}


def test_windowed_errors():
    with pytest.raises(TorchMetricsUserError, match="auto-advances"):
        Windowed(SumMetric(**CPU), 2, advance_every=2, emit=False).advance()
    with pytest.raises(TorchMetricsUserError, match="no per-batch forward"):
        Windowed(SumMetric(**CPU), 2, advance_every=2)(np.asarray([1.0], np.float32))
    with pytest.raises(TorchMetricsUserError, match="cat"):
        Windowed(CatMetric(**CPU), 2, advance_every=2)
    with pytest.raises(ValueError, match="nested"):
        Windowed(Windowed(SumMetric(**CPU), 2), 2)
    with pytest.raises(ValueError, match="nested"):
        Ema(Ema(SumMetric(**CPU)), decay=0.5)
    with pytest.raises(ValueError, match="window >= 1"):
        Windowed(SumMetric(**CPU), 0)
    with pytest.raises(ValueError, match="advance_every >= 1"):
        Windowed(SumMetric(**CPU), 2, advance_every=0)
    with pytest.raises(ValueError, match="Metric instance"):
        Windowed(3, 2)


def test_template_validation_still_runs():
    """Validation is the template's, on the host: a non-binary target still raises."""
    w = Windowed(BinaryAUROC(thresholds=10, **CPU), 2, advance_every=2, emit=False)
    with pytest.raises(RuntimeError, match="binary|0 and 1|values"):
        w.update(np.asarray([0.2, 0.7], np.float32), np.asarray([0, 3]))
    e = Ema(SumMetric(nan_strategy="error", **CPU))
    with pytest.raises(RuntimeError, match="nan"):
        e.update(np.asarray([np.nan], np.float32))


def test_reset_clears_ring_and_counter():
    w = Windowed(SumMetric(**CPU), 2, advance_every=1, emit=False)
    for v in (1.0, 2.0, 3.0):
        w.update(np.asarray([v], np.float32))
    assert w.windows_advanced == 3
    w.reset()
    assert w.windows_advanced == 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert float(w.compute()) == 0.0


def test_descriptors_repr_and_bookkeeping(jax):
    w = Windowed(MeanMetric(**CPU), WINDOW, advance_every=EVERY)
    theirs = jax.online.Windowed(jax.agg.MeanMetric(), WINDOW, advance_every=EVERY)
    assert w.online_descriptor == theirs.online_descriptor == {
        "mode": "sliding", "window": WINDOW, "advance_every": EVERY, "template": "MeanMetric"}
    assert repr(w) == repr(theirs) and w.series_name == theirs.series_name == "online.MeanMetric.w3"
    e, je = Ema(SumMetric(**CPU), decay=0.9), jax.online.Ema(jax.agg.SumMetric(), decay=0.9)
    assert e.online_descriptor == je.online_descriptor and repr(e) == repr(je) and e.series_name == je.series_name
    for name in (SLOT_STATE, COUNT_STATE, ADVANCES_STATE):
        assert w._state.tensors[name].dtype == torch.int32
    assert Windowed.fast_update and Ema.fast_update and not Windowed.keyed_decomposable and not Ema.keyed_decomposable


def test_advance_emits_series_and_counters():
    base = obs.telemetry.counter("online.windows_advanced").value
    w = Windowed(SumMetric(**CPU), 2, advance_every=2, series="online.test.emission")
    for v in (1.0, 2.0, 3.0, 4.0):
        w.update(np.asarray([v], np.float32))
    assert obs.telemetry.counter("online.windows_advanced").value - base == 2
    series = obs.telemetry.get_series("online.test.emission")
    assert series is not None and series.count == 2 and series.last == 7.0
    assert obs.telemetry.gauge("online.test.emission").value == 7.0
    skipped = obs.telemetry.counter("online.emit_skipped").value
    q = Windowed(StreamingQuantile(q=(0.5, 0.9), capacity=8, **CPU), 2, advance_every=1, series="online.test.q")
    q.update(np.arange(4, dtype=np.float32))
    assert obs.telemetry.counter("online.emit_skipped").value == skipped + 1 and obs.telemetry.get_series("online.test.q") is None
    e = Ema(SumMetric(**CPU), decay=0.5, emit_every=2, series="online.test.ema")
    for v in (1.0, 1.0, 1.0, 1.0):
        e.update(np.asarray([v], np.float32))
    assert obs.telemetry.get_series("online.test.ema").count == 2 and obs.telemetry.get_series("online.test.ema").last == 1.875


def test_window_values_are_copies(monkeypatch):
    """``window_state`` / ``window_values`` return copies, never a graph's static buffer."""
    _on_tier("graph", monkeypatch)
    w = Windowed(StreamingHistogram(bins=4, **CPU), 1, advance_every=None, emit=False)
    w.update(np.asarray([0.1, 0.9], np.float32))
    first = w.window_values()
    state = w.window_state()
    w.update(np.asarray([0.1, 0.9], np.float32))
    assert first.tolist() == [1.0, 0.0, 1.0, 0.0] and state["hist"].tolist() == [1.0, 0.0, 1.0, 0.0]
    assert w.window_values().tolist() == [2.0, 0.0, 2.0, 0.0]


def test_readers_of_one_state_merge_the_ring_once(monkeypatch):
    """The detectors of one monitor that read one window replay its merge once an evaluation; each
    direct read replays it and gets tensors of its own; an update, a reset or a state load shows in
    the next read."""
    _on_tier("graph", monkeypatch)
    w = Windowed(StreamingQuantile(capacity=8, levels=6, **CPU), 3, advance_every=2, emit=False)
    w.update(np.arange(20, dtype=np.float32))
    first = w.window_state()
    replays = dispatch.STATS.replays
    monitor = DriftMonitor(default_drift_specs(w, np.arange(10, dtype=np.float32), name="t-ring-once",
                                               windows=((5.0, 1.0),)))
    monitor.evaluate(now=10.0)
    assert dispatch.STATS.replays - replays == 1
    second = w.window_state()
    assert dispatch.STATS.replays - replays == 2 and first["sketch"] is not second["sketch"]
    assert torch.equal(first["sketch"], second["sketch"])
    w.update(np.arange(5, dtype=np.float32))
    third = w.window_state()
    assert dispatch.STATS.replays - replays == 4 and not torch.equal(third["sketch"], first["sketch"])
    w.reset()
    empty = w.window_state()["sketch"]
    assert float(empty[:, -2].sum()) == 0.0  # every level's count
    defaults = w.metric_state
    w.update(np.arange(3, dtype=np.float32))
    assert not torch.equal(w.window_state()["sketch"], empty)
    w._set_states(defaults)
    assert torch.equal(w.window_state()["sketch"], empty)


def test_collection_windowed_and_metric_seams():
    coll = MetricCollection({"s": SumMetric(**CPU), "m": MaxMetric(**CPU)})
    wc = coll.windowed(WINDOW, advance_every=EVERY, emit=False)
    batches = _stream(17)
    for b in batches:
        wc.update(b)
    out = wc.compute()
    ref_s, ref_m = SumMetric(**CPU), MaxMetric(**CPU)
    for b in _window_batches(batches, WINDOW, EVERY):
        ref_s.update(b)
        ref_m.update(b)
    assert float(out["s"]) == float(ref_s.compute()) and float(out["m"]) == float(ref_m.compute())
    assert not any(m.update_called for m in coll._modules.values())
    w = SumMetric(**CPU).windowed(2, advance_every=2, emit=False)
    assert isinstance(w, Windowed) and w.window == 2
    e = SumMetric(**CPU).ema(decay=0.5)
    assert isinstance(e, Ema) and e.decay == 0.5


# ------------------------------------------------------------------ path O's templates at a small size
@pytest.mark.parametrize("tier", ["graph", "eager"])
def test_o2_o3_templates_as_jax(jax, tier, monkeypatch):
    """Sketched AUROC and multiclass accuracy windowed, binned AUROC decayed: states JAX's (exact for
    the windows' counts, within 1e-6 for the decayed ones), values within 1e-6."""
    _on_tier(tier, monkeypatch)
    rng = np.random.RandomState(61)
    ours = {
        "auroc-window": Windowed(BinaryAUROC(approx="sketch", sketch_bins=64, **CPU), 4, advance_every=3),
        "auroc-ema": Ema(BinaryAUROC(thresholds=20, **CPU), decay=0.9),
        "acc-window": Windowed(MulticlassAccuracy(num_classes=11, **CPU), 4, advance_every=3),
    }
    theirs = {
        "auroc-window": jax.online.Windowed(jax.cls.BinaryAUROC(approx="sketch", sketch_bins=64), 4, advance_every=3),
        "auroc-ema": jax.online.Ema(jax.cls.BinaryAUROC(thresholds=20), decay=0.9),
        "acc-window": jax.online.Windowed(jax.cls.MulticlassAccuracy(num_classes=11), 4, advance_every=3),
    }
    for _ in range(9):  # three advances: the last emission is the current window value
        scores = rng.uniform(0, 1, 50).astype(np.float32)
        clicks = (rng.uniform(0, 1, 50) < scores).astype(np.int32)
        preds, target = rng.randint(0, 11, 50).astype(np.int32), rng.randint(0, 11, 50).astype(np.int32)
        for name, args in (("auroc-window", (scores, clicks)), ("auroc-ema", (scores, clicks)),
                           ("acc-window", (preds, target))):
            ours[name].update(*args)
            theirs[name].update(*args)
    for name in ours:
        for state, value in ours[name].metric_state.items():
            want = np.asarray(theirs[name].metric_state[state])
            if name == "auroc-ema":
                np.testing.assert_allclose(value.numpy(), want, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(value.numpy().astype(np.float64), want.astype(np.float64))
        assert abs(float(ours[name].compute()) - float(theirs[name].compute())) <= 1e-6, name
    assert obs.telemetry.get_series("online.BinaryAUROC.w4").last == float(ours["auroc-window"].window_values())
