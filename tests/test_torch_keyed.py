"""The keyed multi-tenant engine of the port against the JAX package's (``tests/unittests/keyed/
test_keyed_engine.py`` and ``test_keyed_equivalence.py``, less the snapshot, journal and telemetry
cases, which wait for ROADMAP.md queue A item 9).

Batches are integer-valued float32, so float sums are exact: each key's value must equal, bit for
bit, what a dict of plain instances accumulates from the same stream, on the emulated graph tier,
the eager tier and ``buffered``, and equal the JAX package's keyed table. Also: ragged batches, keys
never updated, the ``vmap`` strategy equal to ``segments``, key checks, the collection, the sketched
templates (``BinaryAUROC(approx="sketch")``, ``StreamingHistogram``, ``StreamingQuantile``), the
keyed ``MulticlassAccuracy`` that both packages refuse, and kernel K2's vmap rule: one op call for a
whole vmapped batch.
"""
from __future__ import annotations

import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as port
from torchmetrics_tpu_torch.aggregation import MaxMetric, MeanMetric, MinMetric, SumMetric
from torchmetrics_tpu_torch.keyed import STRATEGIES, KeyedMetric, KeyedMetricCollection
from torchmetrics_tpu_torch.ops import dispatch
from torchmetrics_tpu_torch.ops import hist_pair as k2
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

N_KEYS = 13
AGGREGATORS = ["SumMetric", "MeanMetric", "MaxMetric", "MinMetric"]
TIERS = ["graph", "eager", "buffered"]
CPU = {"device": "cpu"}


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu as jt
    import torchmetrics_tpu.classification as jc
    from torchmetrics_tpu.keyed import KeyedMetric as JaxKeyed
    from torchmetrics_tpu.utils.exceptions import TorchMetricsUserError as JaxUserError

    return SimpleNamespace(top=jt, classification=jc, Keyed=JaxKeyed, UserError=JaxUserError)


def _ids(*vals):
    return np.asarray(vals, np.int32)


def _f32(*vals):
    return np.asarray(vals, np.float32)


def _stream(seed: int, n_batches: int = 6, ragged: bool = False):
    """Seeded mixed-key batches of integer values; keys N-2 and N-1 are never updated."""
    rng = np.random.RandomState(seed)
    batches = []
    for i in range(n_batches):
        size = (5, 1, 9, 4, 7, 3)[i % 6] if ragged else 8
        batches.append((rng.randint(0, N_KEYS - 2, size=size).astype(np.int32), rng.randint(-6, 7, size=size).astype(np.float32)))
    return batches


def _on_tier(tier: str, monkeypatch) -> None:
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", tier != "eager")
    if tier == "eager":
        monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
    else:
        monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)


def _instance_reference(name, batches) -> np.ndarray:
    insts = [getattr(port, name)(**CPU) for _ in range(N_KEYS)]
    for ids, vals in batches:
        for k in np.unique(ids):
            insts[k].update(torch.from_numpy(vals[ids == k]))
    return np.stack([m.compute().numpy() for m in insts])


def _run_keyed(name, batches, tier, monkeypatch, strategy="auto") -> KeyedMetric:
    _on_tier(tier, monkeypatch)
    km = KeyedMetric(getattr(port, name), N_KEYS, strategy=strategy, **CPU)
    if tier == "buffered":
        with km.buffered(3) as buf:
            for ids, vals in batches:
                buf.update(ids, vals)
    else:
        for ids, vals in batches:
            km.update(ids, vals)
    return km


def _jax_keyed(jax, name, batches, **kwargs) -> np.ndarray:
    km = jax.Keyed(getattr(jax.top, name), N_KEYS, **kwargs)
    for ids, vals in batches:
        km.update(ids, vals)
    return np.asarray(km.compute())


# ------------------------------------------------------------------ equivalence
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", AGGREGATORS)
def test_bit_identical_vs_instance_dict_and_jax(jax, monkeypatch, name, tier):
    batches = _stream(seed=3)
    km = _run_keyed(name, batches, tier, monkeypatch)
    keyed = km.compute().numpy()
    assert keyed.shape == (N_KEYS,)
    assert keyed.tobytes() == _instance_reference(name, batches).tobytes()
    assert keyed.tobytes() == _jax_keyed(jax, name, batches).tobytes()
    if tier == "graph":
        assert km._graphs.state is not None


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", ["SumMetric", "MeanMetric"])
def test_ragged_key_batches(monkeypatch, name, tier):
    batches = _stream(seed=5, n_batches=8, ragged=True)
    km = _run_keyed(name, batches, tier, monkeypatch)
    assert km.compute().numpy().tobytes() == _instance_reference(name, batches).tobytes()


@pytest.mark.parametrize("name", AGGREGATORS)
def test_never_updated_keys_match_fresh_instances(monkeypatch, name):
    km = _run_keyed(name, _stream(seed=7), "graph", monkeypatch)
    keyed = km.compute().numpy()
    fresh = getattr(port, name)(**CPU).compute().numpy()  # -inf / +inf / 0.0 by class
    for k in (N_KEYS - 2, N_KEYS - 1):
        assert keyed[k].tobytes() == fresh.tobytes()


@pytest.mark.parametrize("name", ["SumMetric", "MeanMetric", "MaxMetric"])
def test_vmap_strategy_matches_segments(monkeypatch, name):
    batches = _stream(seed=9)
    seg = _run_keyed(name, batches, "graph", monkeypatch, strategy="segments")
    vm = _run_keyed(name, batches, "graph", monkeypatch, strategy="vmap")
    assert seg.strategy == "segments" and vm.strategy == "vmap"
    assert seg.compute().numpy().tobytes() == vm.compute().numpy().tobytes()


def test_vmap_bit_identical_on_inexact_floats():
    """The vmap strategy keeps the per-element order of the instance loop, so inexact floats agree bitwise."""
    rng = np.random.RandomState(1)
    batches = [(rng.randint(0, N_KEYS, size=8).astype(np.int32), rng.rand(8).astype(np.float32)) for _ in range(4)]
    km = KeyedMetric(SumMetric, N_KEYS, strategy="vmap", **CPU)
    insts = [SumMetric(**CPU) for _ in range(N_KEYS)]
    for ids, vals in batches:
        km.update(ids, vals)
        for i in range(len(ids)):
            insts[ids[i]].update(torch.tensor(vals[i]))
    assert km.compute().numpy().tobytes() == np.stack([m.compute().numpy() for m in insts]).tobytes()


def test_fold_depth_is_the_largest_count_of_one_key_as_a_power_of_two():
    from torchmetrics_tpu_torch.keyed.engine import _depth_of

    assert _depth_of(np.array([[0, 1, 2]]), 4) == 1
    assert _depth_of(np.array([[0, 1, 1, 2, 1]]), 4) == 4  # key 1 three times
    assert _depth_of(np.array([[3, 3, 3, 3, 3, -1, 9]]), 4) == 8  # out-of-range owners are not counted
    assert _depth_of(np.array([[0, 0], [1, 2]]), 4) == 2  # the deepest row of a stack
    assert _depth_of(np.zeros((1, 0), np.int64), 4) == 1


@pytest.mark.parametrize("tier", ["graph", "eager"])
def test_vmap_fold_runs_its_depth_not_the_batch(monkeypatch, tier):
    """A batch of 64 elements with at most 8 of one key takes 8 vmapped template updates, not 64,
    and equals the instance loop bit for bit on inexact floats, with a skewed key and out-of-range
    owners (``validate_keys=False``) that change nothing. The graph tier keeps one graph per depth."""
    _on_tier(tier, monkeypatch)
    rng = np.random.RandomState(12)
    ids = np.concatenate([np.arange(N_KEYS), np.arange(N_KEYS), np.arange(N_KEYS), [4, 4], rng.randint(0, N_KEYS, 21),
                          [-1, N_KEYS + 3]]).astype(np.int32)
    ids[:40] = rng.permutation(ids[:40])
    vals = rng.rand(64).astype(np.float32)
    km = KeyedMetric(MeanMetric, N_KEYS, strategy="vmap", validate_keys=False, **CPU)
    calls = []
    original = km.template._update
    monkeypatch.setattr(km.template, "_update", lambda *a, **k: calls.append(1) or original(*a, **k))
    captures = dispatch.STATS.captures
    km.update(ids, vals)
    most = np.bincount(ids[(ids >= 0) & (ids < N_KEYS)]).max()
    assert 5 <= most <= 8
    assert len(calls) == 8 * (2 if tier == "graph" else 1)  # a capture runs its body twice on the CPU
    skewed = np.full(16, 2, np.int32)  # depth 16: a second graph on the graph tier
    km.update(skewed, vals[:16])
    km.update(ids, vals)  # depth 8 again: a replay
    if tier == "graph":
        assert dispatch.STATS.captures - captures == 2
    insts = [MeanMetric(**CPU) for _ in range(N_KEYS)]
    for batch_ids, batch_vals in ((ids, vals), (skewed, vals[:16]), (ids, vals)):
        for i, k in enumerate(batch_ids):
            if 0 <= k < N_KEYS:
                insts[k].update(torch.tensor(batch_vals[i]))
    assert km.compute().numpy().tobytes() == np.stack([m.compute().numpy() for m in insts]).tobytes()


@pytest.mark.parametrize("tier", ["graph", "eager", "buffered"])
def test_vmap_fold_over_stacked_batches(monkeypatch, tier):
    """``update_batches`` and ``buffered`` fold a stack on the vmap strategy at the stack's deepest
    batch, equal to one update per batch."""
    _on_tier("eager" if tier == "eager" else "graph", monkeypatch)
    batches = _stream(seed=13, n_batches=5)
    batches[2] = (np.full(8, 3, np.int32), batches[2][1])  # one batch of a single key
    one = KeyedMetric(SumMetric, N_KEYS, strategy="vmap", **CPU)
    for ids, vals in batches:
        one.update(ids, vals)
    km = KeyedMetric(SumMetric, N_KEYS, strategy="vmap", **CPU)
    if tier == "buffered":
        with km.buffered(5) as buf:
            for ids, vals in batches:
                buf.update(ids, vals)
    else:
        km.update_batches(np.stack([b[0] for b in batches]), np.stack([b[1] for b in batches]))
    assert km.compute().numpy().tobytes() == one.compute().numpy().tobytes()


def test_segments_on_inexact_floats_within_1e6_of_jax(jax):
    rng = np.random.RandomState(2)
    batches = [(rng.randint(0, N_KEYS, size=64).astype(np.int32), rng.randn(64).astype(np.float32)) for _ in range(5)]
    for name in ("SumMetric", "MeanMetric"):
        km = KeyedMetric(getattr(port, name), N_KEYS, **CPU)
        for ids, vals in batches:
            km.update(ids, vals)
        np.testing.assert_allclose(km.compute().numpy(), _jax_keyed(jax, name, batches), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tier", TIERS)
def test_update_batches_stack_matches_loop(monkeypatch, tier):
    _on_tier(tier, monkeypatch)
    batches = _stream(seed=11)
    km = KeyedMetric(SumMetric, N_KEYS, **CPU)
    if tier == "buffered":
        with km.buffered(len(batches)) as buf:
            for ids, vals in batches:
                buf.update(ids, vals)
    else:
        km.update_batches(np.stack([b[0] for b in batches]), np.stack([b[1] for b in batches]))
    assert km.compute().numpy().tobytes() == _instance_reference("SumMetric", batches).tobytes()


# ------------------------------------------------------------------ construction
def test_construction(jax):
    assert KeyedMetric(SumMetric, 3, **CPU).num_keys == 3
    assert KeyedMetric(SumMetric(**CPU), 3).strategy == "segments"
    assert KeyedMetric(SumMetric(**CPU), 3).device == torch.device("cpu")
    state = KeyedMetric(MeanMetric, 5, **CPU).metric_state
    assert state["mean_value"].shape == (5,) and state["weight"].shape == (5,)
    assert "SumMetric" in repr(KeyedMetric(SumMetric, 4, **CPU))
    assert STRATEGIES == ("auto", "segments", "vmap")


@pytest.mark.parametrize("case", ["num_keys", "object", "nested", "strategy", "list_state", "capture", "segments"])
def test_construction_errors_as_jax(jax, case):
    """Each refusal in both packages, with the same exception type and message."""
    def build(ns, Keyed, device):
        sum_cls = getattr(ns, "SumMetric")
        if case == "num_keys":
            return Keyed(sum_cls, 0, **device)
        if case == "object":
            return Keyed(object, 4, **device)
        if case == "nested":
            return Keyed(Keyed(sum_cls(**device), 2), 4)
        if case == "strategy":
            return Keyed(sum_cls(**device), 4, strategy="magic")
        if case == "list_state":
            return Keyed(ns.CatMetric(**device), 4)
        if case == "capture":
            return Keyed(ns.RetrievalMAP(approx="sketch", **device), 4)
        return Keyed(ns.StreamingQuantile(**device), 4, strategy="segments")

    match = {"num_keys": "num_keys", "object": "Metric instance or subclass", "nested": "nested",
             "strategy": "strategy", "list_state": "cat", "capture": "opts out of jit", "segments": "does not decompose"}[case]
    with pytest.raises(Exception, match=match) as theirs:
        build(jax.top, jax.Keyed, {})
    with pytest.raises(Exception, match=match) as ours:
        build(port, KeyedMetric, CPU)
    assert type(ours.value).__name__ == type(theirs.value).__name__


def test_strategy_resolution():
    assert KeyedMetric(MeanMetric, 4, **CPU).strategy == "segments"
    assert KeyedMetric(MaxMetric, 4, strategy="vmap", **CPU).strategy == "vmap"
    assert KeyedMetric(port.StreamingQuantile(**CPU), 4).strategy == "vmap"
    assert KeyedMetric(port.StreamingHistogram(**CPU), 4).strategy == "segments"
    assert KeyedMetric(port.PearsonCorrCoef(**CPU), 4).strategy == "vmap"  # a callable reduction

    class Hinted(SumMetric):
        keyed_decomposable = False

    assert KeyedMetric(Hinted, 4, **CPU).strategy == "vmap"


# ------------------------------------------------------------------ the protocol
def test_key_checks_as_jax(jax):
    for ids, vals, match in ((_ids(0, 4), _f32(1, 2), "out of range"), (_f32(0.0, 1.0), _f32(1, 2), "integer"),
                             (_ids(0, 1), None, "batch inputs")):
        args = (ids,) if vals is None else (ids, vals)
        with pytest.raises(jax.UserError, match=match):
            jax.Keyed(jax.top.SumMetric, 4).update(*args)
        with pytest.raises(TorchMetricsUserError, match=match):
            KeyedMetric(SumMetric, 4, **CPU).update(*args)
    with pytest.raises(TorchMetricsUserError, match=r"found values in \[-1, 1\]"):
        KeyedMetric(SumMetric, 4, **CPU).update(_ids(-1, 1), _f32(1, 2))


def test_validation_can_be_disabled():
    km = KeyedMetric(SumMetric, 4, validate_keys=False, **CPU)
    km.update(_ids(0, 1, 9), _f32(1, 2, 4))  # no range scan: the out-of-range id is dropped
    assert float(km.compute_key(0)) == 1.0 and km.compute().tolist() == [1.0, 2.0, 0.0, 0.0]


def test_active_keys_and_reset():
    km = KeyedMetric(SumMetric, 8, **CPU)
    km.update(_ids(0, 0, 3), _f32(1, 2, 3))
    km.update(_ids(3, 5), _f32(4, 5))
    assert km.active_keys == 3
    km.reset()
    assert km.active_keys == 0 and km.compute().sum() == 0.0


def test_forward_raises_with_guidance():
    with pytest.raises(TorchMetricsUserError, match="PER KEY"):
        KeyedMetric(SumMetric, 4, **CPU)(_ids(0), _f32(1.0))


def test_update_tier_engages(monkeypatch):
    _on_tier("graph", monkeypatch)
    dispatch.STATS.reset()
    km = KeyedMetric(SumMetric, 6, **CPU)
    for i in range(3):
        km.update(_ids(0, 1, 2), _f32(i, i, i))
    assert dispatch.STATS.captures == 1 and dispatch.STATS.replays == 3 and dispatch.STATS.n_fallbacks == 0
    assert km.state_generation >= 2


def test_weighted_mean_kwargs_route_through(jax):
    km = KeyedMetric(MeanMetric, 3, **CPU)
    km.update(_ids(0, 0, 1), _f32(10, 20, 5), weight=_f32(1, 3, 2))
    ref0 = MeanMetric(**CPU)
    ref0.update(torch.tensor([10.0, 20.0]), weight=torch.tensor([1.0, 3.0]))
    assert float(km.compute_key(0)) == float(ref0.compute())
    assert float(km.compute_key(1)) == 5.0
    theirs = jax.Keyed(jax.top.MeanMetric, 3)
    theirs.update(_ids(0, 0, 1), _f32(10, 20, 5), weight=_f32(1, 3, 2))
    assert km.compute().numpy().tobytes() == np.asarray(theirs.compute()).tobytes()


def test_lazy_gather_matches_full_compute(jax):
    km = KeyedMetric(SumMetric, 10, **CPU)
    km.update(_ids(1, 7, 1), _f32(1, 2, 3))
    full = km.compute().numpy()
    assert km.compute(keys=[7, 1]).tolist() == [full[7], full[1]]
    assert km.compute(keys=np.array([7])).tolist() == [2.0] and float(km.compute_key(7)) == 2.0
    assert km.compute(keys=torch.tensor(1)).tolist() == [4.0]
    with pytest.raises(TorchMetricsUserError, match="out of range"):
        km.compute(keys=[10])
    with pytest.raises(TorchMetricsUserError, match="integer keys"):
        km.compute(keys=[1.0])


# ------------------------------------------------------------------ the collection
def test_collection(jax):
    kc = KeyedMetricCollection([SumMetric(**CPU), MinMetric(**CPU)], num_keys=4)
    assert sorted(kc._modules) == ["MinMetric", "SumMetric"] and kc.num_keys == 4
    kc.update(_ids(0, 2, 0), _f32(3, 7, 1))
    out = kc.compute(keys=[0])
    assert float(out["SumMetric"][0]) == 4.0 and float(out["MinMetric"][0]) == 1.0
    full = kc.compute()
    assert full["SumMetric"].shape == (4,)
    theirs = jax.top.KeyedMetricCollection([jax.top.SumMetric(), jax.top.MinMetric()], num_keys=4)
    theirs.update(_ids(0, 2, 0), _f32(3, 7, 1))
    for name, value in theirs.compute().items():
        assert full[name].numpy().tobytes() == np.asarray(value).tobytes()
    with pytest.raises(TorchMetricsUserError, match="forward"):
        kc(_ids(0), _f32(1.0))
    with pytest.raises(ValueError, match="num_keys"):
        KeyedMetricCollection([KeyedMetric(SumMetric, 3, **CPU)], num_keys=4)
    with pytest.raises(ValueError, match="both named"):
        KeyedMetricCollection([SumMetric(**CPU), SumMetric(**CPU)], num_keys=2)
    named = KeyedMetricCollection({"total": SumMetric(**CPU)}, num_keys=2, prefix="k_")
    named.update(_ids(1), _f32(9.0))
    assert named.compute()["k_total"].tolist() == [0.0, 9.0]
    from_collection = KeyedMetricCollection(port.MetricCollection([SumMetric(**CPU), MaxMetric(**CPU)]), num_keys=2)
    assert sorted(from_collection._modules) == ["MaxMetric", "SumMetric"]


def test_pickle_and_clone():
    km = KeyedMetric(MeanMetric, 4, **CPU)
    km.update(_ids(1, 1), _f32(3, 5))
    clone = pickle.loads(pickle.dumps(km))
    assert clone.num_keys == 4 and clone.strategy == "segments"
    assert clone.compute().numpy().tobytes() == km.compute().numpy().tobytes()
    clone.update(_ids(0), _f32(7.0))
    assert float(clone.compute_key(0)) == 7.0
    other = km.clone()
    other.update(_ids(1), _f32(10.0))
    assert float(km.compute_key(1)) == 4.0 and float(other.compute_key(1)) == 6.0


# ------------------------------------------------------------------ sketched templates
@pytest.mark.parametrize("tier", ["graph", "eager"])
def test_keyed_sketched_auroc(jax, monkeypatch, tier):
    """Each key's histogram pair equals, exactly, that of a plain sketched ``BinaryAUROC`` fed that key's
    rows, and the JAX package's keyed table; values within 1e-6 of both."""
    _on_tier(tier, monkeypatch)
    rng = np.random.RandomState(57)
    kw = {"approx": "sketch", "sketch_bins": 64}
    ours = KeyedMetric(port.classification.BinaryAUROC(**kw, **CPU), 7)
    theirs = jax.Keyed(jax.classification.BinaryAUROC(**kw), 7)
    plain = [port.classification.BinaryAUROC(**kw, **CPU) for _ in range(7)]
    for _ in range(3):
        ids, scores = rng.randint(0, 6, 200).astype(np.int32), rng.rand(200).astype(np.float32)
        target = (rng.rand(200) < scores).astype(np.int64)
        ours.update(ids, scores, target)
        theirs.update(ids, scores, target)
        for k in range(7):
            if (ids == k).any():
                plain[k].update(torch.from_numpy(scores[ids == k]), torch.from_numpy(target[ids == k]))
    for name in ("pos_hist", "neg_hist"):
        table = ours.metric_state[name]
        assert table.shape == (7, 64)
        np.testing.assert_array_equal(table.numpy(), np.asarray(theirs.metric_state[name]))
        for k in range(7):
            assert torch.equal(table[k], plain[k].metric_state[name])
    values = ours.compute().numpy()
    np.testing.assert_allclose(values, np.asarray(theirs.compute()), atol=1e-6)
    np.testing.assert_allclose(values[:6], [float(m.compute()) for m in plain[:6]], atol=1e-6)


def test_keyed_streaming_histogram(jax):
    rng = np.random.RandomState(8)
    ours, theirs = KeyedMetric(port.StreamingHistogram(bins=16, **CPU), 9), jax.Keyed(jax.top.StreamingHistogram(bins=16), 9)
    for _ in range(3):
        ids, vals = rng.randint(0, 9, 300).astype(np.int32), rng.normal(0.5, 0.4, 300).astype(np.float32)
        ours.update(ids, vals)
        theirs.update(ids, vals)
    np.testing.assert_array_equal(ours.compute().numpy(), np.asarray(theirs.compute()))


@pytest.mark.parametrize("tier", ["graph", "eager"])
def test_keyed_streaming_quantile_on_the_vmap_strategy(jax, monkeypatch, tier):
    """Each key's KLL state bit-equal to the JAX package's and to a per-key instance fed its values one at a time."""
    _on_tier(tier, monkeypatch)
    rng = np.random.RandomState(4)
    kw = {"q": (0.25, 0.5), "capacity": 8, "levels": 6}
    ours, theirs = KeyedMetric(port.StreamingQuantile(**kw, **CPU), 5), jax.Keyed(jax.top.StreamingQuantile(**kw), 5)
    insts = [port.StreamingQuantile(**kw, **CPU) for _ in range(5)]
    for _ in range(2):
        ids, vals = rng.randint(0, 4, 24).astype(np.int32), rng.normal(0, 1, 24).astype(np.float32)
        ours.update(ids, vals)
        theirs.update(ids, vals)
        for i in range(len(ids)):
            insts[ids[i]].update(torch.tensor([vals[i]]))
    table = ours.metric_state["sketch"]
    assert table.numpy().tobytes() == np.asarray(theirs.metric_state["sketch"]).tobytes()
    for k in range(5):
        assert table[k].numpy().tobytes() == insts[k].metric_state["sketch"].numpy().tobytes()
    assert ours.compute().numpy().tobytes() == np.asarray(theirs.compute()).tobytes()


def test_keyed_multiclass_accuracy_raises_in_both(jax):
    """The per-element vmap strips the batch axis the template's formatting reads: both packages raise
    ``IndexError`` (ROADMAP.md, queue C)."""
    rng = np.random.RandomState(0)
    args = (rng.randint(0, 7, 10).astype(np.int32), rng.randint(0, 5, 10), rng.randint(0, 5, 10))
    with pytest.raises(IndexError):
        jax.Keyed(jax.classification.MulticlassAccuracy(num_classes=5, average="micro"), 7).update(*args)
    with pytest.raises(IndexError):
        KeyedMetric(port.classification.MulticlassAccuracy(num_classes=5, average="micro", **CPU), 7).update(*args)


# ------------------------------------------------------------------ K2's vmap rule
def _counting(monkeypatch, name):
    calls = []
    original = getattr(k2, name)

    def counted(*args, **kwargs):
        calls.append((tuple(args[0].shape), args[-1] if isinstance(args[-1], int) else None))
        return original(*args, **kwargs)

    monkeypatch.setattr(k2, name, counted)
    return calls


def test_k2_vmap_rule_is_one_op_call_per_vmapped_call(monkeypatch):
    """A keyed update of a sketched AUROC over 50 elements reaches ``sketch_update``'s op once, and a
    keyed ``StreamingHistogram`` reaches ``hist_pair``'s op once: the rule's one call over every element."""
    sketch_calls, pair_calls = _counting(monkeypatch, "sketch_update_plain"), _counting(monkeypatch, "hist_pair_plain")
    rng = np.random.RandomState(1)
    auroc = KeyedMetric(port.classification.BinaryAUROC(approx="sketch", sketch_bins=32, **CPU), 4)
    auroc.update(rng.randint(0, 4, 50), rng.rand(50).astype(np.float32), rng.randint(0, 2, 50))
    # one multilabel call of scores (N, B) = (1, 50); its plain chain's one hist_pair of 50 x 32 bins
    assert sketch_calls == [((1, 50), None)] and pair_calls == [((50,), 50 * 32)]
    hist = KeyedMetric(port.StreamingHistogram(bins=8, **CPU), 4)
    hist.update(rng.randint(0, 4, 50), rng.rand(50).astype(np.float32))
    assert len(sketch_calls) == 1 and pair_calls[1:] == [((50,), 50 * 8)]  # 50 elements' rows of 8 bins: one call
    rows = torch.func.vmap(lambda i, w: k2.hist_pair(i, w, None, 5))(torch.tensor([[0, 4], [9, 1]]), torch.ones(2, 2))
    assert torch.equal(rows, torch.tensor([[[1.0, 0, 0, 0, 1], [0] * 5], [[0, 1.0, 0, 0, 0], [0] * 5]]))
    with pytest.raises(NotImplementedError, match="binary kind"):
        torch.func.vmap(lambda s: k2.sketch_update(s, torch.zeros(2, dtype=torch.int64), torch.zeros(2, 8),
                                                   torch.zeros(2, 8), "multiclass"))(torch.rand(3, 2, 2))


@pytest.mark.cuda
def test_k2_vmap_rule_on_the_card():
    """On the card, the keyed sketched AUROC and the keyed histogram launch K2 once per update through
    the vmap rule, and their tables equal the CPU's (the plain versions behind the same ops):
    ``python -m pytest --noconftest tests/test_torch_keyed.py -m cuda``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = torch.device("cuda", 0)
    rng = np.random.RandomState(3)
    ids, scores, target = rng.randint(0, 9, 4096).astype(np.int32), rng.rand(4096).astype(np.float32), rng.randint(0, 2, 4096)
    for template, args, counter in (
        (lambda d: port.classification.BinaryAUROC(approx="sketch", sketch_bins=256, device=d), (ids, scores, target),
         k2.SKETCH_UPDATE),
        (lambda d: port.StreamingHistogram(bins=32, device=d), (ids, scores), k2.HIST_PAIR),
    ):
        tables = {}
        for device in (card, torch.device("cpu")):
            km = KeyedMetric(template(device), 9)
            before = counter.launches
            for _ in range(3):
                km.update(*args)
            torch.cuda.synchronize()
            if device.type == "cuda":
                # the graph tier: the first update's warm-up launches, its capture does not, then one replay an update
                assert counter.launches - before == 4
            tables[device.type] = {k: v.cpu() for k, v in km.metric_state.items()}
        for name, value in tables["cpu"].items():
            assert torch.equal(tables["cuda"][name], value), name
