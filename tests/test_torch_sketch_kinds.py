"""The KLL and count-min sketches and the two streaming metrics of the port against the JAX package.

The same numpy inputs, made from a seed, go through ``torchmetrics_tpu.sketch`` and
``torchmetrics_tpu_torch.sketch``. The count-min bucket indices, states and queries must be equal
(float weights within 1e-6: float sums in another order); the KLL state equal bit for bit after every
update and merge, at odd sizes, at fewer samples than ``capacity``, at enough to fill ten levels of
``capacity=16``, and with NaN and infinities; quantiles, CDF and KS distance equal, PSI within 1e-6.
``StreamingQuantile`` and ``StreamingHistogram`` go through ``update``, ``forward``,
``update_batches`` and ``compute`` on the eager tier and the emulated graph tier.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.sketch as ps
from torchmetrics_tpu_torch.ops import dispatch
from torchmetrics_tpu_torch.sketch import countmin as pcm
from torchmetrics_tpu_torch.sketch import kll as pk

SPECIAL_IDS = np.array([0, 1, -1, 2**31 - 1, -(2**31), 2**31, 2**32 - 1, 2**32, -(2**63), 2**63 - 1], np.int64)


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


# ------------------------------------------------------------------ count-min
@pytest.mark.parametrize("depth, width", [(4, 1024), (8, 77), (1, 2), (3, 65536)])
def test_hash_rows_equal_jax_s(jax, depth, width):
    """The bucket indices themselves, for the edge ids and random int64 and int32 ids: the low 32 bits
    of an id, as JAX's int32 wrap and uint32 cast give them, hashed by 16-bit halves."""
    rng = np.random.RandomState(depth * width)
    for ids in (SPECIAL_IDS, rng.randint(-(2**62), 2**62, 2000).astype(np.int64),
                rng.randint(-(2**31), 2**31 - 1, 2000).astype(np.int32)):
        want = np.asarray(jax.cm._hash_rows(jax.jnp.asarray(ids), depth, width))
        got = pcm._hash_rows(torch.from_numpy(ids), depth, width).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weights", ["none", "mask", "float"])
def test_update_and_query_equal_jax_s(jax, weights):
    rng = np.random.RandomState(3)
    state_j, state_p = jax.cm.cm_init(), pcm.cm_init()
    for n in (1, 777, 4096):
        ids = (rng.zipf(1.3, n) % 5000).astype(np.int32)
        w = {"none": None, "mask": rng.rand(n) < 0.5, "float": rng.rand(n).astype(np.float32)}[weights]
        state_j = jax.cm.cm_update(state_j, jax.jnp.asarray(ids), None if w is None else jax.jnp.asarray(w.astype(np.float32)))
        state_p = pcm.cm_update(state_p, torch.from_numpy(ids), None if w is None else torch.from_numpy(w))
        assert state_p.dtype == torch.float32 and state_p.shape == (4, 1024)
        if weights == "float":
            np.testing.assert_allclose(state_p.numpy(), np.asarray(state_j), rtol=1e-6, atol=1e-6)
        else:
            assert _bits(state_p) == _bits(state_j)
    probe = np.unique(ids)[:300]
    want = np.asarray(jax.cm.cm_query(state_j, jax.jnp.asarray(probe)))
    got = pcm.cm_query(state_p, torch.from_numpy(probe)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_count_min_is_one_sided_and_merges_by_sum():
    rng = np.random.RandomState(0)
    ids = (rng.zipf(1.5, 20_000) % 100_000).astype(np.int64)
    state = pcm.cm_init()
    for i in range(0, len(ids), 4096):
        state = pcm.cm_update(state, torch.from_numpy(ids[i:i + 4096]))
    uniq, true = np.unique(ids, return_counts=True)
    est = pcm.cm_query(state, torch.from_numpy(uniq)).numpy()
    assert (est >= true).all()
    assert np.mean(est - true <= pcm.cm_error_bound() * len(ids)) >= 1 - np.exp(-4)
    a = pcm.cm_update(pcm.cm_init(), torch.from_numpy(ids[:9000]))
    b = pcm.cm_update(pcm.cm_init(), torch.from_numpy(ids[9000:]))
    whole = pcm.cm_update(pcm.cm_init(), torch.from_numpy(ids))
    assert torch.equal(a + b, whole)
    assert torch.equal(pcm.cm_query(pcm.cm_init(), torch.zeros(0, dtype=torch.int64)), torch.zeros(0))


def test_count_min_checks_and_sizes_as_jax(jax):
    for kwargs in ({"depth": 0}, {"depth": 9}, {"width": 1}):
        with pytest.raises(ValueError, match="countmin"):
            jax.cm.cm_init(**kwargs)
        with pytest.raises(ValueError, match="countmin"):
            pcm.cm_init(**kwargs)
    assert pcm.cm_error_bound(512) == jax.cm.cm_error_bound(512)
    assert pcm.cm_state_bytes(3, 100) == jax.cm.cm_state_bytes(3, 100)


# ------------------------------------------------------------------ KLL
def _kll_pair(jax, capacity, levels, sizes, seed, kind="normal"):
    """Both packages' states after each batch of ``sizes``, checked bit for bit after every update."""
    rng = np.random.RandomState(seed)
    update = jax.jit(jax.kll.kll_update)
    sj, sp = jax.kll.kll_init(capacity, levels), pk.kll_init(capacity, levels)
    stream = []
    for n in sizes:
        v = rng.normal(0, 3, n).astype(np.float32) if kind == "normal" else rng.randint(0, 17, n).astype(np.float32)
        if kind == "nan" and n > 3:
            v = rng.normal(0, 3, n).astype(np.float32)
            v[[0, n // 2]] = np.nan
            v[1], v[2] = np.inf, -np.inf
        stream.append(v)
        sj, sp = update(sj, jax.jnp.asarray(v)), pk.kll_update(sp, torch.from_numpy(v))
        assert _bits(sp) == _bits(sj), (capacity, levels, n)
    return sj, sp, np.concatenate(stream)


@pytest.mark.parametrize("capacity, levels, sizes, kind", [
    (16, 10, (1, 3, 17, 31, 255, 1023), "normal"),  # odd sizes
    (128, 24, (50, 77), "normal"),  # fewer samples than capacity
    (16, 10, (4096, 4095, 1), "normal"),  # 8192 = 16·2^9 samples: all ten levels in use, none lost
    (16, 10, (999, 999), "dupes"),
    (32, 10, (7, 400, 9000), "nan"),  # NaN and +-inf among the values
    (16, 6, (700, 700), "normal"),  # beyond capacity·2^(levels-1): the top level's carry is dropped in both
])
def test_kll_state_bit_equal_to_jax_s(jax, capacity, levels, sizes, kind):
    sj, sp, stream = _kll_pair(jax, capacity, levels, sizes, seed=capacity + levels, kind=kind)
    assert float(pk.kll_count(sp)) == float(jax.kll.kll_count(sj))
    if len(stream) <= capacity * 2 ** (levels - 1):
        assert float(pk.kll_count(sp)) == len(stream)  # weight is exact below the top level's overflow
    else:
        assert float(pk.kll_count(sp)) < len(stream)
    if len(stream) == 8192:
        assert bool((sp[:, capacity] > 0).all())  # every level holds items
    if kind == "nan":  # NaN sorts after +inf and the zeros keep their order, as in JAX: the fragments agree
        batch = np.concatenate([stream[-50:], np.array([0.0, -0.0, np.nan, np.inf, -0.0], np.float32)])
        ours, theirs = pk._bulk_fragments(torch.from_numpy(batch), 16), jax.kll._bulk_fragments(jax.jnp.asarray(batch), 16)
        assert [lvl for lvl, _ in ours] == [lvl for lvl, _ in theirs]
        assert all(_bits(a) == _bits(b) for (_, a), (_, b) in zip(ours, theirs))
        tail = torch.sort(torch.from_numpy(batch)).values[-2:].numpy()
        assert tail[0] == np.inf and np.isnan(tail[1])


def test_kll_merge_commutes_and_the_stacked_fold_is_the_pairwise_one(jax):
    parts = [_kll_pair(jax, 16, 10, (n, 3 * n + 1), seed=n)[:2] for n in (700, 2000, 31)]
    (aj, ap), (bj, bp), (cj, cp) = parts
    ab = pk.kll_merge(ap, bp)
    assert _bits(ab) == _bits(jax.kll.kll_merge(aj, bj)) == _bits(pk.kll_merge(bp, ap))
    stacked = pk.kll_merge_stacked(torch.stack([ap, bp, cp]))
    assert _bits(stacked) == _bits(pk.kll_merge(ab, cp))
    assert _bits(stacked) == _bits(jax.kll.kll_merge_stacked(jax.jnp.stack([aj, bj, cj])))
    assert float(pk.kll_count(stacked)) == float(pk.kll_count(ap) + pk.kll_count(bp) + pk.kll_count(cp))
    assert _bits(pk.kll_merge(ap, pk.kll_init(16, 10))) == _bits(ap)
    with pytest.raises(ValueError, match="cannot merge"):
        pk.kll_merge(pk.kll_init(16, 8), pk.kll_init(32, 8))
    assert pk.kll_merge_stacked.traceable


def test_kll_queries_equal_jax_s(jax):
    sj, sp, stream = _kll_pair(jax, 128, 24, (5000, 5000, 333), seed=12)
    s2j, s2p, _ = _kll_pair(jax, 128, 24, (4000,), seed=13)
    qs = np.array([0.0, 0.02, 0.1, 0.5, 0.9, 0.99, 1.0], np.float32)
    assert _bits(pk.kll_quantiles(sp, torch.from_numpy(qs))) == _bits(jax.kll.kll_quantiles(sj, jax.jnp.asarray(qs)))
    xs = np.linspace(-9, 9, 37).astype(np.float32)
    assert _bits(pk.kll_cdf(sp, torch.from_numpy(xs))) == _bits(jax.kll.kll_cdf(sj, jax.jnp.asarray(xs)))
    assert float(pk.kll_ks_distance(sp, s2p)) == float(jax.kll.kll_ks_distance(sj, s2j))
    for bins in (4, 10, 37):
        np.testing.assert_allclose(float(pk.kll_psi(sp, s2p, bins)), float(jax.kll.kll_psi(sj, s2j, bins)), rtol=1e-6)
    for a, b in zip(pk.kll_weighted_points(sp), jax.kll.kll_weighted_points(sj)):
        assert _bits(a) == _bits(b)
    data = np.sort(stream)
    for q in np.linspace(0.02, 0.98, 17):  # the documented bound
        est = float(pk.kll_quantiles(sp, torch.tensor([q]))[0])
        lo, hi = np.searchsorted(data, est, "left") / data.size, np.searchsorted(data, est, "right") / data.size
        assert lo - pk.DEFAULT_RANK_ERROR <= q <= hi + pk.DEFAULT_RANK_ERROR
    empty = pk.kll_init()
    assert torch.isnan(pk.kll_quantiles(empty, torch.tensor([0.5]))).all()
    assert torch.isnan(pk.kll_ks_distance(empty, sp))


def test_kll_init_checks_and_sizes_as_jax(jax):
    for kwargs in ({"capacity": 7}, {"capacity": 6}, {"capacity": 9}, {"levels": 1}):
        with pytest.raises(ValueError, match="kll"):
            jax.kll.kll_init(**kwargs)
        with pytest.raises(ValueError, match="kll"):
            pk.kll_init(**kwargs)
    assert _bits(pk.kll_init(16, 5)) == _bits(jax.kll.kll_init(16, 5))
    assert pk.kll_state_bytes() == jax.kll.kll_state_bytes() < 16_384


def test_kll_update_under_vmap_equals_each_element_alone():
    vals = torch.from_numpy(np.random.RandomState(15).uniform(size=(4, 300)).astype(np.float32))
    stacked = torch.func.vmap(pk.kll_update)(torch.stack([pk.kll_init()] * 4), vals)
    for k in range(4):
        assert torch.equal(stacked[k], pk.kll_update(pk.kll_init(), vals[k]))


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
