"""The port's durable snapshots (``robust/checkpoint.py``) against the JAX package's.

- A snapshot that the JAX package takes and saves (``snapshot_metric`` + ``save_snapshot``) of thirteen
  ported classes (classification counts, a confusion matrix, binned and sketched AUROC, regression sums and a
  ``cat`` list, retrieval, an aggregation, a text count and a text list state, a detection list state,
  ``Windowed`` and a keyed metric) loads in the port (``load_snapshot``), restores into a fresh metric, and
  computes JAX's value; JAX's int32 and float32 counts become the port's int64.
- The port's own round trip is bit-equal, and the restored metric and the original stay bit-equal when both
  take one more batch.
- A corrupt, truncated or version-mismatched blob or file, and a blob of another class, geometry, key space
  or sketch, is refused with JAX's message; so are snapshots with batches pending in ``buffered``.
- The reconciliation handshake (``reconciliation_offer``, ``accept_reconciliation`` in ``adopt`` and
  ``verify`` modes) takes JAX's offers and refuses a bad one as JAX does.
"""
from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as port
from torchmetrics_tpu_torch.robust import checkpoint
from torchmetrics_tpu_torch.utils.exceptions import ReconciliationError, SnapshotError


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu as jt
    from torchmetrics_tpu.keyed import KeyedMetric
    from torchmetrics_tpu.online import Windowed
    from torchmetrics_tpu.robust import checkpoint as jck
    from torchmetrics_tpu.utils.exceptions import ReconciliationError as JaxReconciliationError
    from torchmetrics_tpu.utils.exceptions import SnapshotError as JaxSnapshotError

    return SimpleNamespace(top=jt, ck=jck, KeyedMetric=KeyedMetric, Windowed=Windowed,
                           SnapshotError=JaxSnapshotError, ReconciliationError=JaxReconciliationError)


def _logits(rng, n=24, c=5):
    return rng.randn(n, c).astype(np.float32), rng.randint(0, c, n)


def _scores(rng, n=40):
    return rng.rand(n).astype(np.float32), rng.randint(0, 2, n)


def _pairs(rng, n=30):
    x = rng.randn(n).astype(np.float32)
    return x, (x + 0.5 * rng.randn(n)).astype(np.float32)


def _texts(rng, n=6):
    words = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran"]
    refs = [" ".join(rng.choice(words, rng.randint(2, 7))) for _ in range(n)]
    hyps = [" ".join(rng.choice(words, rng.randint(1, 7))) for _ in range(n)]
    return hyps, refs


def _boxes(rng):
    from tests.test_torch_state_interop import _detection_batch

    return _detection_batch(rng, "IntersectionOverUnion")


#: name -> (constructor over a namespace of the package's classes, batch maker)
CASES = {
    "MulticlassAccuracy": (lambda ns, d: ns.classification.MulticlassAccuracy(num_classes=5, **d), _logits),
    "MulticlassConfusionMatrix": (lambda ns, d: ns.classification.MulticlassConfusionMatrix(num_classes=5, **d), _logits),
    "BinaryAUROC binned": (lambda ns, d: ns.classification.BinaryAUROC(thresholds=11, **d), _scores),
    "BinaryAUROC sketch": (lambda ns, d: ns.classification.BinaryAUROC(approx="sketch", sketch_bins=64, **d), _scores),
    "MeanSquaredError": (lambda ns, d: ns.MeanSquaredError(**d), _pairs),
    "SpearmanCorrCoef": (lambda ns, d: ns.SpearmanCorrCoef(**d), _pairs),
    "RetrievalMAP": (lambda ns, d: ns.RetrievalMAP(**d),
                     lambda rng: (rng.rand(20).astype(np.float32), rng.randint(0, 2, 20), rng.randint(0, 4, 20))),
    "MeanMetric": (lambda ns, d: ns.MeanMetric(**d), lambda rng: (rng.randn(9).astype(np.float32),)),
    "WordErrorRate": (lambda ns, d: ns.WordErrorRate(**d), _texts),
    "EditDistance none": (lambda ns, d: ns.EditDistance(reduction="none", **d), _texts),
    "IntersectionOverUnion": (lambda ns, d: ns.IntersectionOverUnion(class_metrics=True, **d), _boxes),
    "Windowed": (lambda ns, d: ns.Windowed(ns.classification.MulticlassAccuracy(num_classes=5, **d), 4,
                                           advance_every=2, **d), _logits),
    "KeyedMetric": (lambda ns, d: ns.KeyedMetric(ns.SumMetric(**d), 4, **d),
                    lambda rng: (rng.randint(0, 4, 12), rng.randn(12).astype(np.float32))),
}


def _ns(jax):
    return SimpleNamespace(**{n: getattr(jax.top, n) for n in ("MeanSquaredError", "SpearmanCorrCoef", "RetrievalMAP",
                                                                "MeanMetric", "WordErrorRate", "EditDistance",
                                                                "IntersectionOverUnion", "SumMetric")},
                           classification=jax.top.classification, Windowed=jax.Windowed, KeyedMetric=jax.KeyedMetric)


def _to_port(batch):
    """A numpy batch as the port takes it: arrays as CPU tensors, detection dicts of tensors, strings as they are."""
    def conv(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x))
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list) and x and isinstance(x[0], dict):
            return [conv(e) for e in x]
        return x
    return tuple(conv(x) for x in batch)


def _to_jax(batch):
    import jax.numpy as jnp

    return tuple([{k: jnp.asarray(v) for k, v in d.items()} for d in x] if isinstance(x, list) and x
                 and isinstance(x[0], dict) else x for x in batch)


def _values(v):
    if isinstance(v, dict):
        return {k: _values(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_values(x) for x in v]
    return np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float64)


def _close(got, want, tol=1e-6):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], tol)
    elif isinstance(want, list):
        for g, w in zip(got, want):
            _close(g, w, tol)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol, equal_nan=True)


def _bits(m):
    return {k: v.numpy().tobytes() for k, v in m._state.tensors.items()}, \
        {k: [e.numpy().tobytes() for e in v] for k, v in m._state.lists.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_jax_snapshot_restores_in_the_port(jax, name, tmp_path):
    build, batch = CASES[name]
    rng = np.random.RandomState(len(name))
    batches = [batch(rng) for _ in range(3)]
    theirs = build(_ns(jax), {})
    for b in batches[:2]:
        theirs.update(*_to_jax(b))
    path = jax.ck.save_snapshot(jax.ck.snapshot_metric(theirs), tmp_path / "jax.tmsnap")
    ours = build(port, {"device": "cpu"})
    ours.restore(checkpoint.load_snapshot(path))
    for key in ("tp", "fp", "tn", "fn", "confmat", "total"):
        if key in ours._state.tensors and not name.startswith(("BinaryAUROC", "MeanSquared")):
            assert ours._state.tensors[key].dtype == ours._defaults[key].dtype
    _close(_values(ours.compute()), _values(theirs.compute()))
    # the port's own round trip, then one more batch on both: bit-equal
    saved = checkpoint.save_snapshot(ours.snapshot(), os.fspath(tmp_path / "port.tmsnap"))
    again = build(port, {"device": "cpu"})
    again.restore(checkpoint.load_snapshot(saved))
    assert _bits(again) == _bits(ours) and again.update_count == ours.update_count == 2
    for m in (ours, again):
        m.update(*_to_port(batches[2]))
    assert _bits(again) == _bits(ours)


def _messages(jax, fn_jax, fn_port):
    with pytest.raises(jax.SnapshotError) as theirs:
        fn_jax()
    with pytest.raises(SnapshotError) as ours:
        fn_port()
    return str(ours.value), str(theirs.value)


def test_corrupt_and_mismatched_blobs_are_refused_as_jax_refuses_them(jax, tmp_path):
    rng = np.random.RandomState(0)
    p, t = _logits(rng)
    theirs = jax.top.classification.MulticlassAccuracy(num_classes=5)
    theirs.update(p, t)
    blob = jax.ck.snapshot_metric(theirs)
    fresh = lambda: port.classification.MulticlassAccuracy(num_classes=5, device="cpu")  # noqa: E731
    jfresh = lambda: jax.top.classification.MulticlassAccuracy(num_classes=5)  # noqa: E731

    flipped = dict(blob, tensors=dict(blob["tensors"]))
    flipped["tensors"]["tp"] = blob["tensors"]["tp"].copy()
    flipped["tensors"]["tp"][0] += 1
    stale = dict(blob, version=0)
    alien = dict(blob, format="something-else")
    other = dict(blob, **{"class": "MulticlassF1Score"})
    renamed = dict(blob, tensors={("xp" if k == "tp" else k): v for k, v in blob["tensors"].items()})
    renamed["crc"] = jax.ck._checksum(renamed["tensors"], renamed["lists"])
    for bad in (flipped, stale, alien, other, renamed):
        ours, theirs = _messages(jax, lambda: jfresh().restore(bad), lambda: fresh().restore(bad))
        assert ours == theirs
    # the disk container: a one-byte flip, a truncation and a foreign file, each with JAX's message (the paths
    # differ only by name)
    path = jax.ck.save_snapshot(blob, tmp_path / "a.tmsnap")
    raw = open(path, "rb").read()
    cases = {"flip": raw[:-5] + bytes([raw[-5] ^ 1]) + raw[-4:], "cut": raw[:-3], "foreign": b"not a snapshot at all"}
    for label, data in cases.items():
        bad_path = tmp_path / f"{label}.tmsnap"
        bad_path.write_bytes(data)
        ours, theirs = _messages(jax, lambda: jax.ck.load_snapshot(bad_path), lambda: checkpoint.load_snapshot(bad_path))
        assert ours == theirs
    # a wider shape or another dtype than the metric's
    wide = port.classification.MulticlassAccuracy(num_classes=6, device="cpu")
    with pytest.raises(SnapshotError, match="shape/dtype"):
        wide.restore(blob)
    f64 = dict(blob, tensors={k: v.astype(np.float64) for k, v in blob["tensors"].items()})
    f64["crc"] = jax.ck._checksum(f64["tensors"], f64["lists"])
    with pytest.raises(SnapshotError, match="shape/dtype"):
        fresh().restore(f64)
    # not whole counts for an int64 state
    half = dict(blob, tensors={k: v + np.float32(0.5) for k, v in blob["tensors"].items()})
    half["crc"] = jax.ck._checksum(half["tensors"], half["lists"])
    with pytest.raises(ValueError, match="not whole"):
        fresh().restore(half)


@pytest.mark.parametrize("kind", ["window", "keys", "sketch"])
def test_descriptors_refuse_another_geometry_as_jax(jax, kind):
    rng = np.random.RandomState(1)
    if kind == "window":
        j = jax.Windowed(jax.top.classification.MulticlassAccuracy(num_classes=5), 4, advance_every=2)
        j.update(*_logits(rng))
        build = lambda ns, d: ns.Windowed(ns.classification.MulticlassAccuracy(num_classes=5, **d), 4,  # noqa: E731
                                          advance_every=3, **d)
    elif kind == "keys":
        j = jax.KeyedMetric(jax.top.SumMetric(), 4)
        j.update(rng.randint(0, 4, 6), rng.randn(6).astype(np.float32))
        build = lambda ns, d: ns.KeyedMetric(ns.MeanMetric(**d), 4, **d)  # noqa: E731
    else:
        j = jax.top.classification.BinaryAUROC(approx="sketch", sketch_bins=64)
        j.update(*_scores(rng))
        build = lambda ns, d: ns.classification.BinaryAUROC(approx="sketch", sketch_bins=32, **d)  # noqa: E731
    blob = j.snapshot()
    ns = SimpleNamespace(Windowed=jax.Windowed, KeyedMetric=jax.KeyedMetric, MeanMetric=jax.top.MeanMetric,
                         classification=jax.top.classification)
    ours, theirs = _messages(jax, lambda: build(ns, {}).restore(blob), lambda: build(port, {"device": "cpu"}).restore(blob))
    assert ours == theirs


def test_pending_batches_refuse_a_snapshot_as_jax(jax):
    rng = np.random.RandomState(2)
    p, t = _logits(rng)
    j = jax.top.classification.MulticlassAccuracy(num_classes=5)
    m = port.classification.MulticlassAccuracy(num_classes=5, device="cpu")
    jbuf, buf = j.buffered(4), m.buffered(4)
    jbuf.update(p, t)
    buf.update(torch.from_numpy(p), torch.from_numpy(t))
    ours, theirs = _messages(jax, j.snapshot, m.snapshot)
    assert ours == theirs
    buf.flush()
    m._state.inflight = True  # a graph step writing the state buffers
    with pytest.raises(SnapshotError, match="mid-flight"):
        m.snapshot()
    m._state.inflight = False
    assert m.snapshot()["update_count"] == 1


def test_collection_round_trip_keeps_compute_groups(tmp_path):
    rng = np.random.RandomState(3)
    build = lambda: port.MetricCollection([port.classification.MulticlassAccuracy(num_classes=5, device="cpu"),  # noqa: E731
                                           port.classification.MulticlassF1Score(num_classes=5, device="cpu")])
    mc = build()
    batches = [tuple(torch.from_numpy(a) for a in _logits(rng)) for _ in range(3)]
    for b in batches[:2]:
        mc.update(*b)
    path = checkpoint.save_snapshot(mc.snapshot(), tmp_path / "mc.tmsnap")
    back = build()
    back.update(*batches[0])  # groups formed, then overwritten
    back.restore(checkpoint.load_snapshot(path))
    for m in (mc, back):
        m.update(*batches[2])
    assert {k: float(v) for k, v in back.compute().items()} == {k: float(v) for k, v in mc.compute().items()}
    assert back._modules["MulticlassF1Score"]._state.tensors["tp"] is back._modules["MulticlassAccuracy"]._state.tensors["tp"]
    with pytest.raises(SnapshotError, match="members"):
        port.MetricCollection([port.classification.MulticlassAccuracy(num_classes=5, device="cpu")]).restore(mc.snapshot())


@pytest.mark.parametrize("mode", ["adopt", "verify"])
def test_reconciliation_takes_jax_offers(jax, mode):
    rng = np.random.RandomState(4)
    p, t = _logits(rng)
    j = jax.top.classification.MulticlassAccuracy(num_classes=5)
    j.update(p, t)
    offer = jax.ck.reconciliation_offer(j, responding_ranks=(0, 2), epoch=7)
    m = port.classification.MulticlassAccuracy(num_classes=5, device="cpu")
    meta = checkpoint.accept_reconciliation(m, offer, mode=mode)
    assert meta == {"responding_ranks": (0, 2), "epoch": 7, "consistency": "full", "mode": mode}
    if mode == "adopt":
        assert float(m.compute()) == pytest.approx(float(j.compute()), rel=1e-6)
    else:
        assert m.update_count == 0
    ours_offer = checkpoint.reconciliation_offer(m, (1,), 3)
    assert ours_offer["format"] == offer["format"] and ours_offer["snapshot"]["format"] == offer["snapshot"]["format"]
    bad = dict(offer, snapshot=dict(offer["snapshot"], crc=1))
    jm = jax.top.classification.MulticlassAccuracy(num_classes=5)
    with pytest.raises(jax.ReconciliationError) as theirs:
        jax.ck.accept_reconciliation(jm, bad, mode=mode)
    with pytest.raises(ReconciliationError) as ours:
        checkpoint.accept_reconciliation(port.classification.MulticlassAccuracy(num_classes=5, device="cpu"), bad, mode=mode)
    assert str(ours.value) == str(theirs.value)


def test_one_host_copy_per_block(monkeypatch):
    """The states of a snapshot are read in one transfer (blocks of ``SNAPSHOT_BLOCK_BYTES``), each array of its
    own dtype and shape."""
    values = [torch.arange(6, dtype=torch.int64).reshape(2, 3), torch.tensor(True), torch.randn(5, dtype=torch.float64),
              torch.zeros((0, 4), dtype=torch.float32), torch.tensor([1.5, -2.0], dtype=torch.float16)]
    arrays = checkpoint.host_arrays(values)
    for v, a in zip(values, arrays):
        assert a.dtype == v.numpy().dtype and a.shape == tuple(v.shape) and a.tobytes() == v.numpy().tobytes()
    monkeypatch.setattr(checkpoint, "SNAPSHOT_BLOCK_BYTES", 16)
    for v, a in zip(values, checkpoint.host_arrays(values)):
        assert a.tobytes() == v.numpy().tobytes()


@pytest.mark.cuda
def test_round_trip_on_the_card_mid_stream(tmp_path):
    """On the card, a snapshot taken mid-stream on the graph tier, saved, loaded and restored into a fresh metric,
    then fed the rest of the stream, gives the uninterrupted run's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda", 0)
    rng = np.random.RandomState(8)
    batches = [tuple(torch.from_numpy(a).to(device) for a in _logits(rng, n=512, c=50)) for _ in range(6)]
    build = lambda: port.MetricCollection([port.classification.MulticlassAccuracy(num_classes=50, device=device),  # noqa: E731
                                           port.classification.MulticlassConfusionMatrix(num_classes=50, device=device)])
    whole, first = build(), build()
    for b in batches:
        whole(*b)
    for b in batches[:3]:
        first(*b)
    path = checkpoint.save_snapshot(first.snapshot(), tmp_path / "mid.tmsnap")
    second = build()
    second.restore(checkpoint.load_snapshot(path))
    for b in batches[3:]:
        second(*b)
    for name, m in whole.items(keep_base=True):
        other = second[name]
        assert {k: v.cpu().numpy().tobytes() for k, v in m._state.tensors.items()} == \
            {k: v.cpu().numpy().tobytes() for k, v in other._state.tensors.items()}, name
