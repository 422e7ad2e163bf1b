"""The port's state sync (``parallel/sync.py``, ``Metric.sync``/``unsync``/``sync_context``) against
the JAX package's, in an emulated world.

The port gets a name-keyed gather built like the JAX tests' ``_sync_replicas``
(``tests/unittests/helpers/testers.py:150``): replica 0 syncs against every replica's state. The same
replica states, made from seeded numpy data, go through the JAX package's ``_sync_replicas`` and
through the port, over 2 and 3 replicas: every ``dist_reduce_fx``, uneven and empty list states,
path A's collection with its compute group, retrieval MAP, Pearson split 37/63, binned and
sketched AUROC, and ``MeanMetric``'s weighted mean. Each result is held to JAX and to one replica
fed all the data: counts exactly, values within 1e-6 relative (stat scores, sums) or 1e-5 (curves,
retrieval, Pearson). The one exception is an empty replica 0: at world 1 the JAX package skips the
gather of an empty list state (``sync.py:1129``), so its result loses the other replicas' data;
the port gathers, and is held to numpy's concatenation.

Also here: JAX's ``test_sync_context_errors`` and ``test_compute_cache``
(``tests/unittests/bases/test_metric.py:62,109``), the base keywords of every exported class held to
the JAX package's, the emulated graph tier through a synced compute, and ``dist_sync_on_step``.
"""
from __future__ import annotations

import inspect
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as port
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.ops import dispatch
from torchmetrics_tpu_torch.parallel import FULL, SyncOptions, process_sync
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import torchmetrics_tpu as jt
    import torchmetrics_tpu.classification as jc
    from torchmetrics_tpu.metric import Metric as JaxMetric
    from torchmetrics_tpu.parallel.sync import SyncOptions as JaxSyncOptions
    from tests.unittests.helpers.testers import _sync_replicas

    return SimpleNamespace(jnp=jnp, top=jt, classification=jc, Metric=JaxMetric,
                           SyncOptions=JaxSyncOptions, sync_replicas=_sync_replicas)


def port_gather(replicas):
    """A world of ``len(replicas)`` processes: a name-keyed gather against every replica's state, as
    the JAX tests' ``_sync_replicas`` builds it (an empty list state gives an empty piece)."""
    states = [{**rep._tensors, **{k: list(v) for k, v in rep._lists.items()}} for rep in replicas]

    def fake_gather(value, group=None, name=None):
        assert name is not None, "the engine must pass the state name to the gather"
        vals = []
        for s in states:
            v = s[name]
            if isinstance(v, list):
                v = torch.cat([torch.atleast_1d(e) for e in v]) if v else torch.zeros_like(torch.atleast_1d(value))[:0]
            vals.append(v)
        return vals

    return fake_gather


def port_sync_replicas(replicas):
    rep0 = replicas[0]
    rep0.dist_sync_fn = port_gather(replicas)
    rep0.distributed_available_fn = lambda: True
    return rep0.compute()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(ours, theirs, rtol):
    if isinstance(ours, dict):
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            _close(ours[k], theirs[k], rtol)
        return
    if isinstance(ours, (tuple, list)):
        for o, t in zip(ours, theirs):
            _close(o, t, rtol)
        return
    o, t = _np(ours), np.asarray(theirs)
    assert o.shape == t.shape, (o.shape, t.shape)
    if np.issubdtype(t.dtype, np.integer) and np.issubdtype(o.dtype, np.integer):
        np.testing.assert_array_equal(o, t)
    else:
        np.testing.assert_allclose(o, t, rtol=rtol, atol=rtol * 0.1, equal_nan=True)


def _split(n_parts, *arrays, sizes=None, seed=0):
    """The rows of ``arrays`` in ``n_parts`` consecutive shares (``sizes`` rows each, else seeded)."""
    n = len(arrays[0])
    if sizes is None:
        cuts = np.sort(np.random.RandomState(seed).choice(np.arange(1, n), n_parts - 1, replace=False))
    else:
        cuts = np.cumsum(sizes)[:-1]
    return [tuple(a[lo:hi] for a in arrays) for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, n])]


# ------------------------------------------------------------------ every reduction
def _reduction_metrics(jax, fx):
    jnp = jax.jnp

    class JaxDummy(jax.Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            if fx == "cat":
                self.add_state("x", [], dist_reduce_fx="cat")
            else:
                init = {"max": -jnp.inf, "min": jnp.inf}.get(fx if isinstance(fx, str) else "", 0.0)
                self.add_state("x", jnp.full((3,), init, jnp.float32),
                               dist_reduce_fx=(lambda s: jnp.sum(s, axis=0)) if fx == "callable" else fx)

        def _update(self, state, v):
            if fx == "cat":
                return {"x": v}
            if fx == "max":
                return {"x": jnp.maximum(state["x"], jnp.max(v, axis=0))}
            if fx == "min":
                return {"x": jnp.minimum(state["x"], jnp.min(v, axis=0))}
            if fx == "mean":
                return {"x": jnp.mean(v, axis=0)}
            return {"x": state["x"] + jnp.sum(v, axis=0)}

        def _compute(self, state):
            x = state["x"]
            return jnp.sum(x, axis=0) if fx is None and x.ndim == 2 else x

    class PortDummy(Metric):
        full_state_update = True

        def __init__(self, **kw):
            super().__init__(**kw)
            if fx == "cat":
                self.add_state("x", [], dist_reduce_fx="cat")
            else:
                init = {"max": -np.inf, "min": np.inf}.get(fx if isinstance(fx, str) else "", 0.0)
                self.add_state("x", torch.full((3,), init, dtype=torch.float32),
                               dist_reduce_fx=(lambda s: torch.sum(s, dim=0)) if fx == "callable" else fx)

        def _update(self, state, v):
            if fx == "cat":
                return {"x": v}
            if fx == "max":
                return {"x": torch.maximum(state["x"], v.amax(0))}
            if fx == "min":
                return {"x": torch.minimum(state["x"], v.amin(0))}
            if fx == "mean":
                return {"x": v.mean(0)}
            return {"x": state["x"] + v.sum(0)}

        def _compute(self, state):
            x = state["x"]
            return x.sum(0) if fx is None and x.ndim == 2 else x

    return JaxDummy, PortDummy


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("fx", ["sum", "mean", "max", "min", "cat", None, "callable"])
def test_every_reduction_matches_jax_and_one_replica(jax, fx, world):
    JaxDummy, PortDummy = _reduction_metrics(jax, fx)
    rng = np.random.RandomState(3)
    data = rng.randn(37, 3).astype(np.float32)
    shares = _split(world, data, seed=world)
    ours = [PortDummy(device="cpu") for _ in range(world)]
    theirs = [JaxDummy() for _ in range(world)]
    for o, t, (share,) in zip(ours, theirs, shares):
        for chunk in np.array_split(share, 2):
            o.update(torch.from_numpy(chunk))
            t.update(jax.jnp.asarray(chunk))
    got = port_sync_replicas(ours)
    want = jax.sync_replicas(theirs)
    _close(got, want, 1e-6)
    if fx == "mean":  # each replica holds the mean of its last chunk; the world's is their mean
        want_mean = np.mean([np.array_split(share, 2)[1].mean(0) for (share,) in shares], 0)
        np.testing.assert_allclose(got.numpy(), want_mean, rtol=1e-6)
    else:
        whole = PortDummy(device="cpu")
        whole.update(torch.from_numpy(data))
        _close(got, whole.compute(), 1e-6)
    # unsync put the local state back, the same tensor objects
    assert not ours[0]._is_synced and ours[0].world_consistent == FULL


# ------------------------------------------------------------------ list states
@pytest.mark.parametrize("sizes", [(5, 0, 3), (4, 0), (2, 6), (3, 0, 0)])
def test_uneven_and_empty_list_states(jax, sizes):
    """CatMetric over uneven replicas, some empty; held to JAX and to numpy's concatenation."""
    rng = np.random.RandomState(sum(sizes))
    data = rng.randn(sum(sizes)).astype(np.float32)
    shares = _split(len(sizes), data, sizes=sizes)
    ours = [port.CatMetric(device="cpu") for _ in sizes]
    theirs = [jax.top.CatMetric() for _ in sizes]
    for o, t, (share,) in zip(ours, theirs, shares):
        if len(share):
            o.update(torch.from_numpy(share))
            t.update(jax.jnp.asarray(share))
    got = port_sync_replicas(ours)
    np.testing.assert_array_equal(got.numpy(), data)
    _close(got, jax.sync_replicas(theirs), 1e-7)


@pytest.mark.parametrize("world", [2, 3])
def test_empty_caller_gathers_the_world(jax, world):
    """The reference-side difference: replica 0 empty. The JAX package skips the gather at world 1
    (``sync.py:1129``) and its replica 0 computes over nothing; the port gathers the other replicas'
    rows, held to numpy's concatenation."""
    data = np.arange(1, 3 * world + 1, dtype=np.float32)
    shares = [(np.zeros(0, np.float32),)] + [(data[3 * i:3 * i + 3],) for i in range(world - 1)]
    ours = [port.CatMetric(device="cpu") for _ in range(world)]
    theirs = [jax.top.CatMetric() for _ in range(world)]
    for o, t, (share,) in zip(ours[1:], theirs[1:], shares[1:]):
        o.update(torch.from_numpy(share))
        t.update(jax.jnp.asarray(share))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = port_sync_replicas(ours)
    np.testing.assert_array_equal(got.numpy(), np.concatenate([s[0] for s in shares]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # replica 0 computes before its own update, in both packages
        jax_value = jax.sync_replicas(theirs)
    assert np.asarray(jax_value).size == 0  # the quirk the port does not keep


def test_empty_payload_keeps_dtype_and_trailing_shape():
    """An empty replica's piece does not promote an int64 state or break a (N, d) one."""
    ids = [torch.arange(4, dtype=torch.int64), torch.zeros(0, dtype=torch.float32), torch.arange(3, dtype=torch.int64)]
    synced = process_sync({"ids": [ids[0]]}, {"ids": None}, gather_fn=lambda v, g: ids)
    assert [e.dtype for e in synced["ids"]] == [torch.int64, torch.int64]
    emb = [torch.ones(2, 8), torch.zeros(0), torch.ones(3, 8)]
    synced = process_sync({"emb": []}, {"emb": "cat"}, gather_fn=lambda v, g: emb)
    assert torch.cat(synced["emb"]).shape == (5, 8)
    synced = process_sync({"none": []}, {"none": "cat"}, gather_fn=lambda v, g: [torch.zeros(0), torch.zeros(0)])
    assert synced["none"] == []
    assert synced.world_consistent == FULL and synced.responding_ranks == {"none": (0, 1)}


# ------------------------------------------------------------------ path A's collection
def _collection(ns, jax_side, **kw):
    cls = ns.classification
    extra = {} if jax_side else {"device": "cpu"}
    return [cls.MulticlassAccuracy(num_classes=5, average="micro", **kw, **extra),
            cls.MulticlassPrecision(num_classes=5, average="macro", **kw, **extra),
            cls.MulticlassRecall(num_classes=5, average="macro", **kw, **extra),
            cls.MulticlassF1Score(num_classes=5, average="macro", **kw, **extra)]


@pytest.mark.parametrize("world", [2, 3])
def test_path_a_collection_with_its_compute_group(jax, world):
    """Each member syncs against the local shared state and puts it back before the next member
    syncs: no member counts the world twice."""
    rng = np.random.RandomState(world)
    preds, target = rng.randint(0, 5, 3000), rng.randint(0, 5, 3000)
    shares = _split(world, preds, target, seed=world)
    port_ns = SimpleNamespace(classification=port.classification)
    ours = [port.MetricCollection(_collection(port_ns, False)) for _ in range(world)]
    theirs = [jax.top.MetricCollection(_collection(jax, True)) for _ in range(world)]
    for o, t, (p, tg) in zip(ours, theirs, shares):
        for chunk in range(3):
            sl = slice(chunk * len(p) // 3, (chunk + 1) * len(p) // 3)
            o.update(torch.from_numpy(p[sl]), torch.from_numpy(tg[sl]))
            t.update(jax.jnp.asarray(p[sl]), jax.jnp.asarray(tg[sl]))
    assert list(ours[0].compute_groups.values()) == [list(ours[0]._modules)]
    leader = ours[0]._modules["MulticlassAccuracy"]
    local_tp = leader._tensors["tp"]
    for name in ours[0]._modules:
        member = ours[0]._modules[name]
        member.dist_sync_fn = port_gather([o._modules[name] for o in ours])
        member.distributed_available_fn = lambda: True
    got = ours[0].compute()
    want = {}
    for name in theirs[0].keys(keep_base=True):
        reps = [t[name] for t in theirs]
        want[name] = jax.sync_replicas(reps)
    _close(got, want, 1e-6)
    assert leader._tensors["tp"] is local_tp
    whole = port.MetricCollection(_collection(port_ns, False))
    whole.update(torch.from_numpy(preds), torch.from_numpy(target))
    _close(got, whole.compute(), 1e-6)
    assert ours[0].world_consistent == FULL


# ------------------------------------------------------------------ retrieval, Pearson, curves
@pytest.mark.parametrize("sizes", [(600, 448, 0), (370, 630)])
def test_retrieval_map_over_uneven_replicas(jax, sizes):
    rng = np.random.RandomState(9)
    n = sum(sizes)
    indexes = np.sort(rng.randint(0, 40, n)).astype(np.int64)
    preds = rng.rand(n).astype(np.float32)
    target = rng.randint(0, 2, n).astype(np.int64)
    shares = _split(len(sizes), indexes, preds, target, sizes=sizes)
    ours = [port.RetrievalMAP(device="cpu") for _ in sizes]
    theirs = [jax.top.RetrievalMAP() for _ in sizes]
    for o, t, (i, p, tg) in zip(ours, theirs, shares):
        if len(i):
            o.update(torch.from_numpy(p), torch.from_numpy(tg), indexes=torch.from_numpy(i))
            t.update(jax.jnp.asarray(p), jax.jnp.asarray(tg), indexes=jax.jnp.asarray(i))
    got = port_sync_replicas(ours)
    assert ours[0]._lists["indexes"][0].dtype == torch.int64
    _close(got, jax.sync_replicas(theirs), 1e-5)
    whole = port.RetrievalMAP(device="cpu")
    whole.update(torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(indexes))
    _close(got, whole.compute(), 1e-5)


@pytest.mark.parametrize("num_outputs", [1, 2])
def test_pearson_split_37_63(jax, num_outputs):
    """``dist_reduce_fx=None`` hands ``_merged_state`` a leading world axis, which it folds."""
    rng = np.random.RandomState(37)
    shape = (100,) if num_outputs == 1 else (100, 2)
    x = rng.randn(*shape).astype(np.float32)
    y = (0.6 * x + rng.randn(*shape)).astype(np.float32)
    shares = _split(2, x, y, sizes=(37, 63))
    ours = [port.PearsonCorrCoef(num_outputs=num_outputs, device="cpu") for _ in range(2)]
    theirs = [jax.top.PearsonCorrCoef(num_outputs=num_outputs) for _ in range(2)]
    for o, t, (a, b) in zip(ours, theirs, shares):
        o.update(torch.from_numpy(a), torch.from_numpy(b))
        t.update(jax.jnp.asarray(a), jax.jnp.asarray(b))
    got = port_sync_replicas(ours)
    _close(got, jax.sync_replicas(theirs), 1e-5)
    whole = port.PearsonCorrCoef(num_outputs=num_outputs, device="cpu")
    whole.update(torch.from_numpy(x), torch.from_numpy(y))
    _close(got, whole.compute(), 1e-5)


def test_pearson_at_world_one_takes_the_unstacked_branch():
    """One gathered entry comes back as it is, with no world axis (``sync.py:1219``)."""
    m = port.PearsonCorrCoef(device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(50).astype(np.float32))
    m.update(x, 2 * x + 1)
    value = m.compute()
    m._computed = None
    synced = port_sync_replicas([m])
    assert synced.shape == () and torch.equal(synced, value)


@pytest.mark.parametrize("approx", [None, "sketch"])
def test_binned_and_sketched_auroc(jax, approx):
    """K3's binned confmat and K2's sketch state (their plain versions on the CPU), summed over the world."""
    rng = np.random.RandomState(5)
    scores = rng.rand(3000).astype(np.float32)
    target = rng.randint(0, 2, 3000)
    kw = {"thresholds": 200} if approx is None else {"approx": "sketch"}
    shares = _split(3, scores, target, seed=5)
    ours = [port.classification.BinaryAUROC(device="cpu", **kw) for _ in range(3)]
    theirs = [jax.classification.BinaryAUROC(**kw) for _ in range(3)]
    for o, t, (s, tg) in zip(ours, theirs, shares):
        o.update(torch.from_numpy(s), torch.from_numpy(tg))
        t.update(jax.jnp.asarray(s), jax.jnp.asarray(tg))
    got = port_sync_replicas(ours)
    _close(got, jax.sync_replicas(theirs), 1e-5)
    whole = port.classification.BinaryAUROC(device="cpu", **kw)
    whole.update(torch.from_numpy(scores), torch.from_numpy(target))
    _close(got, whole.compute(), 1e-5)


def test_mean_metric_weighted_mean(jax):
    """``[1, 2, 3]`` and ``[10]``: JAX gives 4.0, the mean of the four values."""
    ours = [port.MeanMetric(device="cpu") for _ in range(2)]
    theirs = [jax.top.MeanMetric() for _ in range(2)]
    for o, t, v in zip(ours, theirs, ([1.0, 2.0, 3.0], [10.0])):
        o.update(torch.tensor(v))
        t.update(jax.jnp.asarray(v))
    got, want = port_sync_replicas(ours), jax.sync_replicas(theirs)
    assert float(got) == float(want) == 4.0


# ------------------------------------------------------------------ clustering and nominal
def _clustering_nominal_data(kind: str, rng):
    """Seeded inputs of 400 rows, as argument tuples of numpy arrays."""
    if kind == "labels":  # gapped and negative cluster ids, 60% of them agreeing
        target = rng.randint(0, 8, 400) * 3 - 4
        return target, np.where(rng.rand(400) < 0.6, target, rng.randint(-4, 20, 400))
    if kind == "data":
        labels = rng.randint(0, 6, 400)
        return (rng.randn(400, 5) + 2 * labels[:, None]).astype(np.float32), labels
    if kind == "nominal":  # codes with 5% NaN in each series
        preds, target = rng.randint(0, 6, 400).astype(np.float32), rng.randint(0, 6, 400).astype(np.float32)
        preds[rng.rand(400) < 0.05] = np.nan
        target[rng.rand(400) < 0.05] = np.nan
        return preds, target
    return (rng.rand(400, 4, 5).astype(np.float32),)


CLUSTERING_NOMINAL_SYNC = {
    "AdjustedMutualInfoScore": ({}, "labels", 1e-4),  # the port's float64 expected MI (ROADMAP queue C)
    "DaviesBouldinScore": ({}, "data", 1e-5),
    "CramersV": ({"num_classes": 6, "nan_strategy": "drop"}, "nominal", 1e-5),
    "FleissKappa": ({"mode": "probs"}, "ratings", 1e-5),
}


@pytest.mark.parametrize("name", sorted(CLUSTERING_NOMINAL_SYNC))
def test_clustering_and_nominal_over_uneven_replicas(jax, name):
    """A label-pair class and a data-label class (``cat`` states), ``CramersV`` with ``"drop"`` (a
    float32 ``sum`` confmat) and ``FleissKappa`` (a ``cat`` state of counts), over two replicas of
    130 and 270 rows: held to the JAX package's sync and to one replica fed all the rows."""
    kwargs, kind, rtol = CLUSTERING_NOMINAL_SYNC[name]
    data = _clustering_nominal_data(kind, np.random.RandomState(len(name)))
    shares = _split(2, *data, sizes=(130, 270))
    ours = [getattr(port, name)(device="cpu", **kwargs) for _ in shares]
    theirs = [getattr(jax.top, name)(**kwargs) for _ in shares]
    for o, t, share in zip(ours, theirs, shares):
        for lo, hi in ((0, 50), (50, len(share[0]))):
            o.update(*(torch.from_numpy(a[lo:hi]) for a in share))
            t.update(*(jax.jnp.asarray(a[lo:hi]) for a in share))
    got = port_sync_replicas(ours)
    _close(got, jax.sync_replicas(theirs), rtol)
    whole = getattr(port, name)(device="cpu", **kwargs)
    whole.update(*(torch.from_numpy(a) for a in data))
    _close(got, whole.compute(), 1e-6)
    assert not ours[0]._is_synced


# ------------------------------------------------------------------ sketches and keyed tables
def _countmin_metrics(jax):
    """A metric holding one count-min state, in each package."""
    from torchmetrics_tpu.sketch import countmin as jcm
    from torchmetrics_tpu.sketch.state import countmin_spec as jax_spec
    from torchmetrics_tpu.sketch.state import register_sketch_state as jax_register

    from torchmetrics_tpu_torch.sketch import countmin as pcm
    from torchmetrics_tpu_torch.sketch.state import countmin_spec, register_sketch_state

    class JaxCounts(jax.Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            jax_register(self, "cms", jax_spec(3, 128))

        def _update(self, state, ids):
            return {"cms": jcm.cm_update(state["cms"], ids)}

        def _compute(self, state):
            return state["cms"]

    class PortCounts(Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            register_sketch_state(self, "cms", countmin_spec(3, 128))

        def _update(self, state, ids):
            return {"cms": pcm.cm_update(state["cms"], ids)}

        def _compute(self, state):
            return state["cms"]

    return JaxCounts, PortCounts


SKETCH_SYNC = ("StreamingQuantile", "countmin", "RetrievalMAP-sketch", "KeyedMetric-Sum", "KeyedMetric-Max")


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", SKETCH_SYNC)
def test_sketch_and_keyed_states_over_uneven_replicas(jax, case, world):
    """Replicas of 130, 270 (and 0) rows. ``StreamingQuantile``'s sketches merge in rank order: the
    synced state is the pairwise fold, bit for bit, and the value JAX's; count-min, retrieval's sketch
    states and the keyed Sum and Max tables reduce by sum, max and min, equal to JAX's and to one
    replica fed all the rows (the MAP within 1e-6)."""
    rng = np.random.RandomState(len(case) + world)
    sizes = (130, 270, 0)[:world]
    cpu = {"device": "cpu"}
    if case == "StreamingQuantile":
        data = (rng.lognormal(3, 1, 400).astype(np.float32),)
        make = (lambda: port.StreamingQuantile(q=(0.5, 0.99), capacity=16, levels=12, **cpu),
                lambda: jax.top.StreamingQuantile(q=(0.5, 0.99), capacity=16, levels=12))
    elif case == "countmin":
        data = ((rng.zipf(1.3, 400) % 1000).astype(np.int64),)
        jax_cls, port_cls = _countmin_metrics(jax)
        make = (lambda: port_cls(**cpu), jax_cls)
    elif case == "RetrievalMAP-sketch":
        data = (rng.rand(400).astype(np.float32), rng.randint(0, 2, 400), np.repeat(np.arange(40), 10).astype(np.int64))
        make = (lambda: port.RetrievalMAP(approx="sketch", **cpu), lambda: jax.top.RetrievalMAP(approx="sketch"))
    else:
        data = (rng.randint(0, 7, 400).astype(np.int32), rng.randint(-9, 10, 400).astype(np.float32))
        template = case.split("-")[1] + "Metric"
        make = (lambda: port.KeyedMetric(getattr(port, template)(**cpu), 7),
                lambda: jax.top.KeyedMetric(getattr(jax.top, template)(), 7))
    shares = _split(world, *data, sizes=sizes)

    def feed(m, share, torch_side):
        if not len(share[0]):
            return
        args = tuple(torch.from_numpy(a) if torch_side else a for a in share)
        if case == "RetrievalMAP-sketch":
            m.update(*args[:2], indexes=args[2])
        else:
            m.update(*args)

    ours, theirs = [make[0]() for _ in sizes], [make[1]() for _ in sizes]
    for o, t, share in zip(ours, theirs, shares):
        feed(o, share, True)
        feed(t, share, False)
    rtol = 1e-6 if case == "RetrievalMAP-sketch" else 0.0
    got = port_sync_replicas(ours)
    _close(got, jax.sync_replicas(theirs), rtol)
    whole = make[0]()
    feed(whole, data, True)
    if case == "StreamingQuantile":
        from torchmetrics_tpu_torch.sketch import kll

        pieces = [o._tensors["sketch"] for o in ours]
        with ours[0].sync_context(dist_sync_fn=port_gather(ours), distributed_available=lambda: True):
            synced = ours[0]._tensors["sketch"]
        folded = pieces[0]
        for piece in pieces[1:]:
            folded = kll.kll_merge(folded, piece)
        assert torch.equal(synced, folded) and float(kll.kll_count(synced)) == 400
    else:
        _close(got, whole.compute(), rtol)
    assert not ours[0]._is_synced


ONLINE_SYNC = ("Windowed-Sum", "Windowed-StreamingQuantile", "Ema-Mean")


@pytest.mark.parametrize("case", ONLINE_SYNC)
def test_online_rings_over_uneven_replicas(jax, case):
    """Two replicas fed batches of 7 and 13 rows in step (the ring bookkeeping syncs by max, as all
    ranks advance together): a ``Windowed(SumMetric)`` ring reduces slab by slab and gives JAX's bits
    and those of one replica fed both shares; a ``Windowed(StreamingQuantile)`` ring merges each slot
    across the ranks on its own (``_slotwise_merge``), bit for bit (the KLL merge itself is held to
    JAX's in ``test_sketch_and_keyed_states_over_uneven_replicas``); ``Ema(MeanMetric)`` within 1e-6
    of JAX's."""
    from torchmetrics_tpu.online import Ema as JEma
    from torchmetrics_tpu.online import Windowed as JWindowed

    rng = np.random.RandomState(len(case))
    kind, template = case.split("-")
    tpl = {"Sum": "SumMetric", "Mean": "MeanMetric"}.get(template, template)
    tkw = {"q": (0.5, 0.9), "capacity": 8, "levels": 10} if template == "StreamingQuantile" else {}
    wkw = {"window": 3, "advance_every": 2, "emit": False} if kind == "Windowed" else {"decay": 0.9}
    batches = [[rng.randint(-6, 7, size).astype(np.float32) for _ in range(7)] for size in (7, 13)]
    ours = [getattr(port, kind)(getattr(port, tpl)(device="cpu", **tkw), **wkw) for _ in range(2)]
    for o, share in zip(ours, batches):
        for b in share:
            o.update(torch.from_numpy(b))
    got = port_sync_replicas(ours)
    if template != "StreamingQuantile":
        theirs = [(JWindowed if kind == "Windowed" else JEma)(getattr(jax.top, tpl)(**tkw), **wkw) for _ in range(2)]
        for t, share in zip(theirs, batches):
            for b in share:
                t.update(b)
        _close(got, jax.sync_replicas(theirs), 1e-6 if kind == "Ema" else 0.0)
    if template == "StreamingQuantile":
        from torchmetrics_tpu_torch.sketch import kll

        rings = [o._tensors["sketch"] for o in ours]
        with ours[0].sync_context(dist_sync_fn=port_gather(ours), distributed_available=lambda: True):
            synced = ours[0]._tensors["sketch"]
        for slot in range(3):
            assert torch.equal(synced[slot], kll.kll_merge(rings[0][slot], rings[1][slot])), slot
    elif kind == "Windowed":
        whole = port.Windowed(port.SumMetric(device="cpu"), **wkw)
        for b0, b1 in zip(*batches):
            whole.update(torch.from_numpy(np.concatenate([b0, b1])))
        assert got.numpy().tobytes() == whole.compute().numpy().tobytes()
    assert not ours[0]._is_synced


IMAGE_SYNC = {
    "StructuralSimilarityIndexMeasure": ({"data_range": 1.0}, (3, 24, 24)),
    "StructuralSimilarityIndexMeasure-none": ({"reduction": "none"}, (1, 24, 24)),
    "PeakSignalNoiseRatio": ({}, (3, 16, 16)),
    "PeakSignalNoiseRatio-dim": ({"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}, (3, 16, 16)),
    "PeakSignalNoiseRatioWithBlockedEffect": ({}, (1, 16, 16)),
    "RootMeanSquaredErrorUsingSlidingWindow": ({}, (3, 16, 16)),
    "ErrorRelativeGlobalDimensionlessSynthesis": ({}, (4, 16, 16)),
    "SpectralDistortionIndex": ({}, (4, 16, 16)),
    "TotalVariation": ({"reduction": "mean"}, (3, 16, 16)),
    "VisualInformationFidelity": ({}, (2, 48, 48)),
}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", sorted(IMAGE_SYNC))
def test_image_states_over_uneven_replicas(jax, case, world):
    """Image states over replicas of 1, 3 (and 2) images: float32 sums, PSNR's ``min``/``max``-reduced
    extremes (zero-initialised, as in JAX), PSNR-B's ``max``-reduced range, TV's integer count and
    the ``cat`` lists (SSIM's per-image values, PSNR's per-image sums, ERGAS's and D-lambda's images),
    held to JAX's sync and to one replica fed all the images within 1e-5 relative."""
    import torchmetrics_tpu.image as ji

    import torchmetrics_tpu_torch.image as ti

    name = case.split("-")[0]
    kwargs, shape = IMAGE_SYNC[case]
    rng = np.random.RandomState(len(case) + world)
    n = (1, 3, 2)[:world]
    target = rng.rand(sum(n), *shape).astype(np.float32)
    preds = np.clip(target + 0.1 * rng.randn(*target.shape), 0, 1).astype(np.float32)
    data = (preds,) if name == "TotalVariation" else (preds, target)
    shares = _split(world, *data, sizes=n)
    ours = [getattr(ti, name)(device="cpu", **kwargs) for _ in shares]
    theirs = [getattr(ji, name)(**kwargs) for _ in shares]
    for o, t, share in zip(ours, theirs, shares):
        o.update(*(torch.from_numpy(a) for a in share))
        t.update(*share)
    got = port_sync_replicas(ours)
    _close(got, jax.sync_replicas(theirs), 1e-5)
    whole = getattr(ti, name)(device="cpu", **kwargs)
    whole.update(*(torch.from_numpy(a) for a in data))
    _close(got, whole.compute(), 1e-5)
    assert not ours[0]._is_synced


GENERATIVE_AUDIO_SYNC = {
    "FrechetInceptionDistance": {"feature": None, "num_features": 6},
    "KernelInceptionDistance": {"feature": None, "subsets": 4, "subset_size": 5, "seed": 3},
    "MemorizationInformedFrechetInceptionDistance": {"feature": None},
    "InceptionScore": {"feature": None, "splits": 2, "seed": 1},
    "SignalNoiseRatio": {},
    "PermutationInvariantTraining": {"mode": "speaker-wise"},
}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name", sorted(GENERATIVE_AUDIO_SYNC))
def test_generative_and_audio_states_over_uneven_replicas(jax, name, world):
    """FID's 14 sum states (the compensated sums and the counts), KID's, MiFID's and IS's ``cat`` lists
    (``dist_reduce_fx=None``: gathered in rank order) and the audio sums over replicas of 4, 9 (and 6)
    rows, held to JAX's sync and to one replica fed all the rows within 1e-5 relative (FID within 1e-4
    of JAX: the port's compute is float64)."""
    import torchmetrics_tpu.audio as ja
    import torchmetrics_tpu.functional.audio as jfa
    import torchmetrics_tpu.image as ji

    import torchmetrics_tpu_torch.audio as pa
    import torchmetrics_tpu_torch.functional.audio as pfa
    import torchmetrics_tpu_torch.image as pi

    kwargs = GENERATIVE_AUDIO_SYNC[name]
    rng = np.random.RandomState(len(name) + world)
    sizes = (4, 9, 6)[:world]
    audio = hasattr(pa, name)
    if audio:
        target = rng.randn(sum(sizes), 2, 64).astype(np.float32)
        data = ((target + 0.3 * rng.randn(*target.shape)).astype(np.float32), target)
        extra = ({"metric_func": jfa.signal_noise_ratio}, {"metric_func": pfa.signal_noise_ratio}) if name.startswith("Perm") else ({}, {})
    else:
        data = (np.abs(rng.randn(sum(sizes), 6)).astype(np.float32) + 0.5, np.abs(rng.randn(sum(sizes), 6)).astype(np.float32))
        extra = ({}, {})

    def make(lib, side):
        return getattr(lib, name)(**kwargs, **extra[side], **({"device": "cpu"} if side else {}))

    def feed(m, arrays, to):
        if audio:
            m.update(*(to(a) for a in arrays))
        elif name == "InceptionScore":
            m.update(to(arrays[0]))
        else:
            m.update(to(arrays[0]), real=True)
            m.update(to(arrays[1]), real=False)

    shares = _split(world, *data, sizes=sizes)
    ours = [make(pa if audio else pi, 1) for _ in shares]
    theirs = [make(ja if audio else ji, 0) for _ in shares]
    for o, t, share in zip(ours, theirs, shares):
        feed(o, share, torch.from_numpy)
        feed(t, share, jax.jnp.asarray)
    got = port_sync_replicas(ours)
    _close(got, jax.sync_replicas(theirs), 1e-4 if "Frechet" in name else 1e-5)
    whole = make(pa if audio else pi, 1)
    feed(whole, data, torch.from_numpy)
    _close(got, whole.compute(), 1e-5)
    assert not ours[0]._is_synced


TEXT_SYNC = {
    "BLEUScore": {"n_gram": 3},
    "CHRFScore": {"return_sentence_level_score": True},
    "ROUGEScore": {"rouge_keys": ("rouge1", "rougeL")},
    "EditDistance": {"reduction": "none"},
}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name", sorted(TEXT_SYNC))
def test_text_states_over_uneven_replicas(jax, name, world):
    """BLEU's count vectors, chrF's six vectors and its sentence ``cat`` list, ROUGE's per-key lists
    (``dist_reduce_fx=None``: gathered in rank order) and EditDistance's distances over replicas of 4, 9
    (and 6) sentence pairs: held to JAX's sync and to one replica fed every pair within 1e-6."""
    import torchmetrics_tpu.functional.text.rouge as jrouge
    import torchmetrics_tpu.text as jtext

    import torchmetrics_tpu_torch.text as ptext
    from torch_text_corpus import hypotheses, sentences

    sizes = (4, 9, 6)[:world]
    refs = sentences(len(name) + world, sum(sizes))
    hyps = hypotheses(refs, world)
    nested = name in ("BLEUScore", "CHRFScore")
    target = [[r] for r in refs] if nested else refs
    bounds = np.cumsum((0,) + sizes)
    shares = [(hyps[a:b], target[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
    saved, jrouge._PUNKT_AVAILABLE = jrouge._PUNKT_AVAILABLE, False
    try:
        ours = [getattr(ptext, name)(**TEXT_SYNC[name], device="cpu") for _ in shares]
        theirs = [getattr(jtext, name)(**TEXT_SYNC[name]) for _ in shares]
        for o, t, share in zip(ours, theirs, shares):
            o.update(*share)
            t.update(*share)
        got = port_sync_replicas(ours)
        _close(got, jax.sync_replicas(theirs), 1e-6)
        whole = getattr(ptext, name)(**TEXT_SYNC[name], device="cpu")
        whole.update(hyps, target)
        _close(got, whole.compute(), 1e-6)
    finally:
        jrouge._PUNKT_AVAILABLE = saved
    assert not ours[0]._is_synced


def _detection_shares(name: str, world: int):
    rng = np.random.RandomState(world + len(name))
    shares = []
    for n_img in (1, 3, 2)[:world]:
        if name == "MeanAveragePrecision":
            preds, target = [], []
            def boxes(n):
                xy = rng.rand(n, 2) * 50
                return np.concatenate([xy, xy + rng.rand(n, 2) * 30 + 2], 1).astype(np.float32)

            for _ in range(n_img):
                n_g, n_d = rng.randint(1, 4), rng.randint(1, 5)
                gt = boxes(n_g)
                det = np.concatenate([gt[:1] + 1, boxes(n_d - 1)])  # one near-match and the rest anywhere
                preds.append({"boxes": det, "scores": rng.rand(n_d).astype(np.float32), "labels": rng.randint(0, 2, n_d)})
                target.append({"boxes": gt, "labels": rng.randint(0, 2, n_g), "iscrowd": (rng.rand(n_g) < 0.2).astype(np.int64)})
            shares.append((preds, target))
        else:
            maps = np.stack([rng.choice([0, 1, 2], (n_img, 6, 6)), rng.randint(0, 3, (n_img, 6, 6))], -1)
            shares.append((maps, np.where(rng.rand(n_img, 6, 6, 1) < 0.3, maps[..., ::-1] % 3, maps)))
    return shares


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("name", ["MeanAveragePrecision", "PanopticQuality"])
def test_detection_states_over_uneven_replicas(jax, name, world):
    """Mean AP's per-image lists (``dist_reduce_fx=None``) and panoptic quality's per-category sums over
    replicas of 1, 3 (and 2) images, held to JAX's sync. Panoptic quality is also one replica's over every
    image. A synced list state holds each rank's entries concatenated, in JAX as here (``process_sync``), so a
    synced mean AP scores each rank's images as one image: held to JAX only."""
    import torchmetrics_tpu.detection as jd

    import torchmetrics_tpu_torch.detection as td

    kwargs = {"things": {1}, "stuffs": {0, 2}} if name == "PanopticQuality" else {"class_metrics": True}
    shares = _detection_shares(name, world)
    ours = [getattr(td, name)(device="cpu", **kwargs) for _ in shares]
    theirs = [getattr(jd, name)(**kwargs) for _ in shares]
    for o, t, (preds, target) in zip(ours, theirs, shares):
        if name == "PanopticQuality":
            o.update(torch.from_numpy(preds), torch.from_numpy(target))
            t.update(jax.jnp.asarray(preds), jax.jnp.asarray(target))
        else:
            o.update([{k: torch.from_numpy(v) for k, v in d.items()} for d in preds],
                     [{k: torch.from_numpy(v) for k, v in d.items()} for d in target])
            t.update([{k: jax.jnp.asarray(v) for k, v in d.items()} for d in preds],
                     [{k: jax.jnp.asarray(v) for k, v in d.items()} for d in target])
    got = port_sync_replicas(ours)
    _close(got, jax.sync_replicas(theirs), 1e-6)
    if name == "PanopticQuality":
        whole = td.PanopticQuality(device="cpu", **kwargs)
        whole.update(torch.from_numpy(np.concatenate([p for p, _ in shares])),
                     torch.from_numpy(np.concatenate([t for _, t in shares])))
        _close(got, whole.compute(), 1e-6)
    assert not ours[0]._is_synced


# ------------------------------------------------------------------ the lifecycle (test_metric.py:62,109)
class DummyMetric(Metric):
    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("x", torch.zeros(()), dist_reduce_fx="sum")

    def _update(self, state, x):
        return {"x": state["x"] + torch.sum(x)}

    def _compute(self, state):
        return state["x"]


def test_compute_cache():
    m = DummyMetric(device="cpu")
    m.update(torch.tensor(1.0))
    v1 = m.compute()
    assert m.compute() is v1
    m.update(torch.tensor(1.0))
    assert float(m.compute()) == 2.0

    m_nc = DummyMetric(device="cpu", compute_with_cache=False)
    m_nc.update(torch.tensor(1.0))
    assert float(m_nc.compute()) == 1.0
    assert m_nc._computed is None


def test_sync_context_errors():
    m = DummyMetric(device="cpu")
    m.update(torch.tensor(1.0))
    with pytest.raises(TorchMetricsUserError, match="has already been un-synced"):
        m.unsync()
    local = m._tensors["x"]
    m.sync(dist_sync_fn=lambda v, g: [v, v], distributed_available=lambda: True)
    assert float(m._tensors["x"]) == 2.0  # sum-reduced over an emulated world of 2
    with pytest.raises(TorchMetricsUserError, match="already been synced"):
        m.sync(dist_sync_fn=lambda v, g: [v, v], distributed_available=lambda: True)
    with pytest.raises(TorchMetricsUserError, match="shouldn't be synced when performing `forward`"):
        m.forward(torch.tensor(1.0))
    with pytest.raises(TorchMetricsUserError, match="Did you forget to call `unsync`"):
        m.update(torch.tensor(1.0))
    with pytest.raises(TorchMetricsUserError, match="Did you forget to call `unsync`"):
        m.update_batches(torch.ones(2, 1))
    m.unsync()
    assert float(m._tensors["x"]) == 1.0 and m._tensors["x"] is local
    with m.sync_context(dist_sync_fn=lambda v, g: [v, v, v], distributed_available=lambda: True):
        assert float(m._tensors["x"]) == 3.0
    assert m._tensors["x"] is local
    # nothing to sync against: no gather and no world
    m.sync()
    assert not m._is_synced
    m.sync(dist_sync_fn=lambda v, g: [v, v])
    m.reset()
    assert not m._is_synced and m._cache is None and m.world_consistent == FULL


def test_sync_on_compute_off_and_callable_reduction_in_forward():
    m = DummyMetric(device="cpu", sync_on_compute=False, dist_sync_fn=lambda v, g: [v, v])
    m.update(torch.tensor(2.0))
    assert float(m.compute()) == 2.0

    class Callable(DummyMetric):
        def __init__(self, **kw):
            Metric.__init__(self, **kw)
            self.add_state("x", torch.zeros(()), dist_reduce_fx=lambda s: torch.sum(s, dim=0))

    c = Callable(device="cpu")
    assert float(c(torch.tensor([1.0, 2.0]))) == 3.0
    assert float(c(torch.tensor([4.0]))) == 4.0
    assert float(c.compute()) == 7.0
    with pytest.raises(ValueError, match="must be callable or one of"):
        c.add_state("bad", torch.zeros(()), dist_reduce_fx="xyz")


def test_clone_shares_the_process_group():
    """A process group is a handle to the world: ``clone`` (and so ``BootStrapper``'s and
    ``MultioutputWrapper``'s copies) shares it instead of copying it."""

    class Group:
        def __deepcopy__(self, memo):
            raise TypeError("a process group cannot be copied")

    group = Group()
    boot = port.BootStrapper(port.SumMetric(device="cpu", process_group=group), num_bootstraps=2)
    assert all(m.process_group is group for m in boot.metrics)


def test_dist_sync_on_step_matches_jax(jax):
    """The batch value of a ``dist_sync_on_step`` forward is synced; the global state is not."""
    gather = lambda v, g: [v, v]  # noqa: E731
    ours = port.SumMetric(device="cpu", dist_sync_on_step=True, dist_sync_fn=gather)
    theirs = jax.top.SumMetric(dist_sync_on_step=True, dist_sync_fn=gather)
    for v in ([1.0, 2.0], [5.0]):
        assert float(ours(torch.tensor(v))) == float(theirs(jax.jnp.asarray(v))) == 2 * sum(v)
    assert float(ours._tensors["sum_value"]) == 8.0 and not ours._is_synced
    assert float(ours.compute()) == float(theirs.compute()) == 16.0


def test_graph_tier_through_a_synced_compute(monkeypatch):
    """forward, compute with sync, forward again: bit-equal to the same loop without sync, on the
    emulated graph tier and on the eager tier; unsync puts back the static buffers themselves."""
    rng = np.random.RandomState(11)
    batches = [(torch.from_numpy(rng.randint(0, 5, 500)), torch.from_numpy(rng.randint(0, 5, 500))) for _ in range(6)]

    def run(tier, synced):
        monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", tier == "graph")
        if tier == "eager":
            monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
        else:
            monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)
        kw = {"dist_sync_fn": lambda v, g: [v, v]} if synced else {}
        m = port.classification.MulticlassAccuracy(num_classes=5, device="cpu", **kw)
        values = [m(*b) for b in batches[:3]]
        before = dict(m._tensors)
        mid = m.compute()
        assert all(m._tensors[k] is v for k, v in before.items())
        values += [m(*b) for b in batches[3:]]
        m._computed = None
        return values, mid, m.compute(), m

    for tier in ("graph", "eager"):
        plain_values, plain_mid, plain_end, _ = run(tier, False)
        sync_values, sync_mid, sync_end, m = run(tier, True)
        assert all(torch.equal(a, b) for a, b in zip(plain_values, sync_values))
        assert torch.equal(sync_mid, plain_mid) and torch.equal(sync_end, plain_end)  # an accuracy: the world of two copies
        if tier == "graph":
            assert m._graphs.state is not None and all(m._tensors[k] is b for k, b in m._graphs.state.items())


# ------------------------------------------------------------------ the base keywords
TASK = {"task": "multiclass", "num_classes": 3}
CONSTRUCT = {
    "AUROC": TASK, "Accuracy": TASK, "AveragePrecision": TASK, "CalibrationError": TASK, "CohenKappa": TASK,
    "ConfusionMatrix": TASK, "ExactMatch": TASK, "F1Score": TASK, "FBetaScore": TASK, "HammingDistance": TASK,
    "HingeLoss": TASK, "JaccardIndex": TASK, "MatthewsCorrCoef": TASK, "Precision": TASK, "PrecisionRecallCurve": TASK,
    "ROC": TASK, "Recall": TASK, "Specificity": TASK, "StatScores": TASK,
    "PrecisionAtFixedRecall": {**TASK, "min_recall": 0.5}, "RecallAtFixedPrecision": {**TASK, "min_precision": 0.5},
    "SpecificityAtSensitivity": {**TASK, "min_sensitivity": 0.5}, "MinkowskiDistance": {"p": 3.0},
    "CramersV": {"num_classes": 3}, "PearsonsContingencyCoefficient": {"num_classes": 3}, "TheilsU": {"num_classes": 3},
    "TschuprowsT": {"num_classes": 3}, "KeyedMetric": {"num_keys": 3}, "Windowed": {"window": 2},
    "Ema": {"decay": 0.9},
    "FrechetInceptionDistance": {"feature": None, "num_features": 4}, "KernelInceptionDistance": {"feature": None},
    "InceptionScore": {"feature": None}, "MemorizationInformedFrechetInceptionDistance": {"feature": None},
    "LearnedPerceptualImagePatchSimilarity": {"net_type": lambda a, b: a},
    "PermutationInvariantTraining": {"metric_func": lambda preds, target: preds},
    "PerceptualEvaluationSpeechQuality": {"fs": 8000, "mode": "nb"}, "ShortTimeObjectiveIntelligibility": {"fs": 8000},
    "SpeechReverberationModulationEnergyRatio": {"fs": 8000},
    "BERTScore": {"encoder": lambda sentences: (np.ones((len(sentences), 2, 3), np.float32),
                                                np.ones((len(sentences), 2), np.int64))},
    "InfoLM": {"masked_lm": lambda sentences: (np.full((len(sentences), 2, 4), 0.25, np.float32),
                                               np.ones((len(sentences), 2), np.int64)), "idf": False},
    "CLIPScore": {"model_name_or_path": (lambda images: np.ones((len(images), 3), np.float32),
                                         lambda text: np.ones((len(text), 3), np.float32))},
    "CLIPImageQualityAssessment": {"model_name_or_path": (lambda images: np.ones((len(images), 3), np.float32),
                                                          lambda text: np.ones((len(text), 3), np.float32))},
    "PanopticQuality": {"things": {1}, "stuffs": {0}}, "ModifiedPanopticQuality": {"things": {1}, "stuffs": {0}},
}
#: keywords that PIT hands to its ``metric_func``, as JAX's does (``audio/metrics.py:247-262``)
PIT_FORWARDED = ("nan_policy", "sync_options", "not_a_keyword")
WRAPPED = {"BootStrapper": "base_metric", "ClasswiseWrapper": "metric", "MinMaxMetric": "base_metric",
           "MultioutputWrapper": "base_metric", "MetricTracker": "metric", "Windowed": "metric", "Ema": "metric"}
#: the exported metric classes (the drift detectors and specs of ``online`` are not metrics)
EXPORTED = [n for n in port.__all__ if inspect.isclass(getattr(port, n)) and issubclass(getattr(port, n), Metric)
            and n not in ("Metric", "MetricCollection", "CompositionalMetric", "KeyedMetricCollection")]


def _build(ns, name, jax_side, **keyword):
    cls = getattr(ns, name)
    device = {} if jax_side else {"device": "cpu"}
    if name in WRAPPED:
        inner = ns.SumMetric(**device)
        extra = {"num_outputs": 2} if name == "MultioutputWrapper" else {}
        return cls(**{WRAPPED[name]: inner}, **extra, **CONSTRUCT.get(name, {}), **keyword)
    if name == "MultitaskWrapper":
        return cls({"a": ns.SumMetric(**device)}, **keyword)
    if name == "KeyedMetric":  # a template and ``num_keys``; the keywords are the keyed metric's own
        return cls(ns.SumMetric(**device), **CONSTRUCT[name], **keyword)
    return cls(**CONSTRUCT.get(name, {}), **device, **keyword)


def _outcome(fn):
    try:
        return fn(), None
    except Exception as err:  # noqa: BLE001 - the exception's type is what is compared
        return None, type(err)


def test_every_export_is_covered():
    assert len(EXPORTED) == 139 and {"BootStrapper", "MetricTracker", "MultitaskWrapper", "CramersV", "DunnIndex",
                                     "StreamingQuantile", "StreamingHistogram", "KeyedMetric", "Windowed",
                                     "Ema", "StructuralSimilarityIndexMeasure", "VisualInformationFidelity",
                                     "FrechetInceptionDistance", "PerceptualPathLength", "SignalNoiseRatio",
                                     "PermutationInvariantTraining", "BLEUScore", "ROUGEScore",
                                     "Perplexity", "BERTScore", "InfoLM", "CLIPScore", "MeanAveragePrecision",
                                     "PanopticQuality", "CompleteIntersectionOverUnion"} <= set(EXPORTED)
    assert not {"DriftMonitor", "DriftSpec", "EwmaBand", "KsDrift", "PsiDrift"} & set(EXPORTED)


@pytest.mark.parametrize("name", EXPORTED)
def test_base_keywords_as_jax_takes_them(jax, name):
    """Each exported class built with each of JAX's base keywords (``metric.py:188-209``) and with an
    unknown one: the port succeeds where the JAX package does, and raises the same exception type
    where it raises."""
    gather = lambda v, g: [v]  # noqa: E731
    keywords = {"compute_on_cpu": True, "dist_sync_on_step": True, "process_group": None, "dist_sync_fn": gather,
                "distributed_available_fn": lambda: False, "sync_on_compute": False, "compute_with_cache": False,
                "nan_policy": "propagate", "sync_options": "options", "not_a_keyword": 1}
    for key, value in keywords.items():
        given = SyncOptions() if value == "options" else value
        ours, our_err = _outcome(lambda: _build(port, name, False, **{key: given}))
        theirs, their_err = _outcome(lambda: _build(jax.top, name, True,
                                                    **{key: jax.SyncOptions() if value == "options" else value}))
        assert our_err == their_err, (name, key, our_err, their_err)
        if ours is not None and name == "PermutationInvariantTraining" and key in PIT_FORWARDED:
            assert ours.kwargs[key] is given, (name, key)
        elif ours is not None and key != "not_a_keyword":
            holder = ours.base_metric if name in ("RunningMean", "RunningSum") else ours  # they pass the keywords on
            assert getattr(holder, key) is given, (name, key)
    with pytest.raises(ValueError, match="Unexpected keyword arguments: `not_a_keyword`"):
        port.SumMetric(device="cpu", not_a_keyword=1)


@pytest.mark.parametrize("key, value, error", [
    ("dist_sync_on_step", 1, ValueError), ("sync_on_compute", "yes", ValueError), ("compute_with_cache", None, ValueError),
    ("dist_sync_fn", 3, ValueError), ("nan_policy", "drop", ValueError), ("nan_policy", "raise", None),
    ("nan_policy", "mask", None), ("sync_options", {"timeout_s": 1}, ValueError),
])
def test_base_keyword_checks(key, value, error):
    if error is None:  # a ported guardrail policy: the metric takes it and registers its poison counter
        m = port.MeanSquaredError(device="cpu", **{key: value})
        assert m.nan_policy == value and "nan_poison_total" in m._defaults
        return
    with pytest.raises(error, match=key):
        port.MeanSquaredError(device="cpu", **{key: value})


@pytest.mark.parametrize("option", [{"timeout_s": 1.0}, {"quorum": 0.5}, {"compression": "int8"}, {"world": 4}])
def test_non_default_sync_options_raise(option):
    """Every field but ``compression`` takes its non-default value (the bounded sync); a compression other than
    ``"none"`` raises, alone or beside the others, naming where the codecs wait."""
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 9b"):
        SyncOptions(**{**option, "compression": "bf16" if "compression" not in option else option["compression"]})
    if "compression" not in option:
        opts = SyncOptions(**option)
        assert all(getattr(opts, k) == v for k, v in option.items()) and opts.compression == "none"
    assert SyncOptions() == SyncOptions(timeout_s=0.0, compression="none")


@pytest.mark.cuda
def test_bounded_gather_runs_on_the_caller_s_card_and_stream():
    """On the card: the bounded sync's worker thread gathers on the caller's current card and stream, so an NCCL
    world of one process per card stays on each process's card, and the gather's device-to-host read waits for
    the caller's pending write on a side stream. Run there with ``python -m pytest --noconftest
    tests/test_torch_sync.py -m cuda``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the worker's current card and stream are CUDA state")
    card = torch.device("cuda", torch.cuda.device_count() - 1)  # a card other than 0 where the host has two
    seen = []

    def gather(value, group=None):
        seen.append((torch.cuda.current_device(), torch.cuda.current_stream()))
        host = value.cpu()
        return [host, host]

    with torch.cuda.device(card):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            x = torch.zeros(1 << 22, dtype=torch.int64, device=card)
            torch.cuda._sleep(100_000_000)  # the write below lands well after the worker starts
            x.fill_(7)
            out = process_sync({"x": x}, {"x": "sum"}, gather_fn=gather, options=SyncOptions(timeout_s=30.0, world=2))
        torch.cuda.synchronize(card)
    assert seen == [(card.index, stream)]
    assert out.world_consistent == "full" and bool((out["x"].cpu() == 14).all())


@pytest.mark.cuda
def test_nccl_world_of_one_on_the_card():
    """On the card: a one-rank NCCL world gathers on the device (the payloads stay there) and gives
    the bits of no sync; ``sync_state``'s collectives keep dtypes; ``compute_on_cpu`` moves list
    entries to the host. Run there with ``python -m pytest --noconftest tests/test_torch_sync.py -m cuda``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs on the card")
    import socket

    import torch.distributed as dist

    from torchmetrics_tpu_torch.parallel import gather_all_arrays, sync_state

    card = torch.device("cuda", 0)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port_number = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port_number}", rank=0, world_size=1, device_id=card)
    try:
        x = torch.arange(6, device=card).reshape(3, 2)
        (g,) = gather_all_arrays(x)
        assert g.device == card and torch.equal(g, x)
        out = sync_state({"n": torch.tensor([3], device=card), "f": torch.tensor([True], device=card), "l": [x]},
                         {"n": "sum", "f": "max", "l": "cat"})
        assert out["n"].dtype == torch.int64 and out["f"].dtype == torch.bool and torch.equal(out["l"][0], x.reshape(3, 2))
        rng = np.random.RandomState(2)
        p, t = torch.from_numpy(rng.randint(0, 5, 4000)).to(card), torch.from_numpy(rng.randint(0, 5, 4000)).to(card)
        synced = port.classification.MulticlassF1Score(num_classes=5, distributed_available_fn=lambda: True)
        plain = port.classification.MulticlassF1Score(num_classes=5)
        for m in (synced, plain):
            for i in range(4):
                m(p[i * 1000:(i + 1) * 1000], t[i * 1000:(i + 1) * 1000])
        assert torch.equal(synced.compute(), plain.compute())
        assert synced._tm_last_sync["bytes_received"] > 0
        cat = port.CatMetric(compute_on_cpu=True)
        cat.update(torch.ones(3, device=card))
        assert cat._lists["value"][0].device.type == "cpu"
        assert float(cat.compute().sum()) == 3.0
    finally:
        dist.destroy_process_group()
