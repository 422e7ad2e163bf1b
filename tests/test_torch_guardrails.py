"""The port's numeric guardrails (``robust/guardrails.py``, ``Metric(nan_policy=...)``) against the JAX
package's.

The same seeded batches, with NaN, +inf and -inf in their float leaves, go through the JAX metric and the
port's (``device="cpu"``) under each of the four policies and along each route into the state (``update``,
``forward``, ``update_batches``, ``buffered``): the poison count, the computed value (1e-6) or the exception
and its message, the guard's warnings and the registered state names (none added under ``"propagate"``) are
JAX's. Also: a grouped collection, ``Windowed`` and a keyed metric with the policy on the wrapper and on the
template, float64 and integer leaves, the counter's sum over the emulated two-rank world of
``test_torch_sync.py``, and the emulated graph tier, which must capture, replay and fall back as it does
without a policy, with the eager tier's bits.
"""
from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as port
from torchmetrics_tpu_torch.ops import dispatch
from torchmetrics_tpu_torch.robust import guardrails

POLICIES = ("propagate", "raise", "warn", "mask")
ROUTES = ("update", "forward", "update_batches", "buffered")


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu as jt
    import torchmetrics_tpu.classification as jc
    from torchmetrics_tpu.keyed import KeyedMetric
    from torchmetrics_tpu.online import Windowed
    from tests.unittests.helpers.testers import _sync_replicas

    return SimpleNamespace(top=jt, classification=jc, KeyedMetric=KeyedMetric, Windowed=Windowed,
                           sync_replicas=_sync_replicas)


def _poisoned(rng, shape, rate=0.15):
    x = rng.randn(*shape).astype(np.float32)
    hit = rng.rand(*shape) < rate
    x[hit] = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32), int(hit.sum()))
    return x


def _batches(kind, seed=0, n=4, rows=8):
    rng = np.random.RandomState(seed)
    if kind == "mean":
        return [(_poisoned(rng, (rows,)),) for _ in range(n)]
    if kind == "accuracy":
        out = []
        for _ in range(n):
            logits = rng.randn(rows, 4).astype(np.float32)
            bad = rng.rand(rows) < 0.3  # one poisoned entry in a poisoned row, so that argmax ties never differ
            logits[bad, rng.randint(0, 4, int(bad.sum()))] = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32),
                                                                         int(bad.sum()))
            out.append((logits, rng.randint(0, 4, rows)))
        return out
    return [(_poisoned(rng, (rows,)), _poisoned(rng, (rows,), 0.05)) for _ in range(n)]


def _build(ns, kind, policy, jax_side):
    device = {} if jax_side else {"device": "cpu"}
    if kind == "mean":
        return ns.MeanMetric(nan_strategy="ignore", nan_policy=policy, **device)
    if kind == "accuracy":
        cls = ns.MulticlassAccuracy if hasattr(ns, "MulticlassAccuracy") else ns.classification.MulticlassAccuracy
        return cls(num_classes=4, nan_policy=policy, **device)
    return ns.MeanSquaredError(nan_policy=policy, **device)


def _ports(batch):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)


def _drive(m, route, batches, convert):
    batches = [convert(b) for b in batches]
    if route == "update":
        for b in batches:
            m.update(*b)
    elif route == "forward":
        for b in batches:
            m(*b)
    elif route == "update_batches":
        stack = np.stack if isinstance(batches[0][0], np.ndarray) else torch.stack
        m.update_batches(*(stack([b[i] for b in batches]) for i in range(len(batches[0]))))
    else:
        with m.buffered(3) as buf:
            for b in batches:
                buf.update(*b)


def _outcome(m):
    """(value, error type and message, the guard's warnings, poison count, state names). JAX's warnings fire
    once per message and process (ROADMAP.md, "Differences the port keeps on purpose"), so its cache is
    cleared first."""
    try:
        from torchmetrics_tpu.utils.prints import reset_warning_cache
    except ImportError:  # the JAX package is absent: only the port's side is read
        pass
    else:
        reset_warning_cache()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            value, err = m.compute(), None
        except Exception as e:  # noqa: BLE001 - the exception and its message are compared
            value, err = None, (type(e).__name__, str(e))
    guard = sorted(str(w.message) for w in caught if "non-finite" in str(w.message))
    value = None if value is None else np.asarray(value.detach().cpu() if isinstance(value, torch.Tensor) else value)
    return value, err, guard, m.nan_poison_count, sorted(m._defaults)


def _same(ours, theirs):
    o_val, o_err, o_warn, o_cnt, o_names = ours
    t_val, t_err, t_warn, t_cnt, t_names = theirs
    assert (o_err, o_warn, o_cnt, o_names) == (t_err, t_warn, t_cnt, t_names)
    if t_val is not None:
        np.testing.assert_allclose(o_val, t_val, rtol=1e-6, atol=1e-7, equal_nan=True)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("kind", ["mean", "accuracy", "mse"])
def test_policy_matrix_matches_jax(jax, kind, policy, route):
    batches = _batches(kind, seed=len(route))
    theirs = _build(jax.top if kind != "accuracy" else jax.classification, kind, policy, True)
    ours = _build(port if kind != "accuracy" else port.classification, kind, policy, False)
    _drive(theirs, route, batches, lambda b: b)
    _drive(ours, route, batches, _ports)
    _same(_outcome(ours), _outcome(theirs))
    if policy == "propagate":
        assert guardrails.POISON_STATE not in ours._defaults and ours.nan_poison_count == 0


@pytest.mark.parametrize("policy", POLICIES)
def test_grouped_collection_matches_jax(jax, policy):
    """Two members of one compute group: the leader's guarded update feeds both, as JAX's group forward."""
    batches = _batches("accuracy", seed=7)
    jc, pc = jax.classification, port.classification
    theirs = jax.top.MetricCollection([jc.MulticlassAccuracy(num_classes=4, nan_policy=policy),
                                       jc.MulticlassPrecision(num_classes=4, nan_policy=policy)])
    ours = port.MetricCollection([pc.MulticlassAccuracy(num_classes=4, nan_policy=policy, device="cpu"),
                                  pc.MulticlassPrecision(num_classes=4, nan_policy=policy, device="cpu")])
    for b in batches:
        theirs(*b)
        ours(*_ports(b))
    assert len(ours._groups) == 1 == len(theirs._groups)
    for name in ("MulticlassAccuracy", "MulticlassPrecision"):
        _same(_outcome(ours[name]), _outcome(theirs[name]))


@pytest.mark.parametrize("policy", ["mask", "raise"])
@pytest.mark.parametrize("where", ["wrapper", "template"])
@pytest.mark.parametrize("kind", ["windowed", "keyed"])
def test_windowed_and_keyed_match_jax(jax, kind, where, policy):
    """The policy on the wrapper guards its update; on the template it registers the counter but the wrapper
    drives the template's plain update, in both packages."""
    x = np.array([1.0, np.nan, 3.0, np.inf, -np.inf, 2.0], np.float32)
    ids = np.array([0, 1, 2, 0, 1, 2])

    def build(ns, windowed, keyed, jax_side):
        device = {} if jax_side else {"device": "cpu"}
        on_tpl = {"nan_policy": policy} if where == "template" else {}
        on_wrap = {"nan_policy": policy} if where == "wrapper" else {}
        if kind == "windowed":
            return windowed(ns.MeanMetric(nan_strategy="ignore", **on_tpl, **device), 4, **on_wrap, **device)
        return keyed(ns.SumMetric(nan_strategy="ignore", **on_tpl, **device), 3, **on_wrap, **device)

    theirs = build(jax.top, jax.Windowed, jax.KeyedMetric, True)
    ours = build(port, port.Windowed, port.KeyedMetric, False)
    for m, conv in ((theirs, np.asarray), (ours, torch.from_numpy)):
        for _ in range(2):
            if kind == "keyed":
                m.update(conv(ids), conv(x))
            else:
                m.update(conv(x))
    _same(_outcome(ours), _outcome(theirs))
    if kind == "keyed" and where == "wrapper":
        got, want = _outcome_keys(ours), _outcome_keys(theirs)
        assert got[1] == want[1]
        if want[0] is not None:
            np.testing.assert_allclose(got[0], want[0], rtol=1e-6)


def _outcome_keys(m):
    try:
        v = m.compute(keys=[0, 2])
        return np.asarray(v.detach() if isinstance(v, torch.Tensor) else v), None
    except Exception as e:  # noqa: BLE001
        return None, (type(e).__name__, str(e))


def test_float64_counts_and_integer_leaves_pass(jax):
    """A float64 leaf counts like a float32 one; integer and bool leaves pass untouched; under "mask" the
    float64 values are zeroed in float64."""
    x = np.array([1.5, np.nan, -np.inf, 4.0], np.float64)
    ints = torch.tensor([1, 2, 3], dtype=torch.int64)
    args, kwargs, bad = guardrails.scrub_nonfinite((torch.from_numpy(x), ints), {"flag": torch.tensor([True])}, True)
    assert float(bad) == 2.0 and bad.dtype == torch.float32
    assert args[0].dtype == torch.float64 and args[0].tolist() == [1.5, 0.0, 0.0, 4.0]
    assert args[1] is ints and kwargs["flag"].dtype == torch.bool
    _, _, none = guardrails.scrub_nonfinite((ints,), {}, False)
    assert none == 0.0
    with pytest.raises(ValueError, match="nan_policy"):
        port.SumMetric(nan_policy="drop", device="cpu")
    with pytest.raises(ValueError) as theirs:
        jax.top.SumMetric(nan_policy="drop")
    with pytest.raises(ValueError) as ours:
        port.SumMetric(nan_policy="drop", device="cpu")
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("policy", ["warn", "mask"])
def test_counter_sums_over_an_emulated_two_rank_world(jax, policy):
    """Each replica counts its own batches; a synced compute sums the counters as a ``sum`` state, in both
    packages, and the synced value is JAX's."""
    from tests.test_torch_sync import port_sync_replicas

    data = _batches("mse", seed=11, n=2, rows=32)
    jreps = [jax.top.MeanSquaredError(nan_policy=policy) for _ in range(2)]
    preps = [port.MeanSquaredError(nan_policy=policy, device="cpu") for _ in range(2)]
    for jr, pr, b in zip(jreps, preps, data):
        jr.update(*b)
        pr.update(*_ports(b))
    counts = [pr.nan_poison_count for pr in preps]
    assert counts == [jr.nan_poison_count for jr in jreps] and all(counts)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = jax.sync_replicas(jreps)
        ours = port_sync_replicas(preps)
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=1e-6, equal_nan=True)
    synced = {}
    preps[0].sync(dist_sync_fn=preps[0].dist_sync_fn)
    synced["port"] = float(preps[0]._state.tensors[guardrails.POISON_STATE])
    preps[0].unsync()
    assert synced["port"] == float(sum(counts))


@pytest.mark.parametrize("kind", ["accuracy", "mse"])
def test_emulated_graph_tier_captures_as_without_a_policy(monkeypatch, kind):
    """On the emulated graph tier each policy captures, replays and falls back as "propagate" does on the same
    stream, and every policy's state is the eager tier's bits."""
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    batches = _batches(kind, seed=3, n=5)
    logs, states = {}, {}
    for policy in POLICIES:
        for tier in ("graph", "eager"):
            if tier == "eager":
                monkeypatch.setenv("TM_TPU_FAST_DISPATCH", "0")
            else:
                monkeypatch.delenv("TM_TPU_FAST_DISPATCH", raising=False)
            dispatch.STATS.reset()
            m = _build(port if kind != "accuracy" else port.classification, kind, policy, False)
            m.fast_update = True
            for i, b in enumerate(batches):
                (m.update if i % 2 else m)(*_ports(b))
            if tier == "graph":
                logs[policy] = (dispatch.STATS.captures, dispatch.STATS.replays, dict(dispatch.STATS.fallbacks))
            states[(policy, tier)] = {k: v.clone() for k, v in m._state.tensors.items()}
        for name, value in states[(policy, "graph")].items():
            assert value.numpy().tobytes() == states[(policy, "eager")][name].numpy().tobytes(), (policy, name)
    assert all(log == logs["propagate"] for log in logs.values()), logs
    assert logs["propagate"][0] >= 2  # a forward and an update step, each captured once


@pytest.mark.cuda
def test_guard_on_the_card_adds_no_capture_and_keeps_the_eager_bits(monkeypatch):
    """On the card, each policy's graph tier captures and replays as "propagate" does, reads no host value per
    step (a step under capture that did would raise), and gives the eager tier's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda", 0)
    batches = _batches("accuracy", seed=9, n=6, rows=256)
    logs, states = {}, {}
    for policy in POLICIES:
        for tier in ("graph", "eager"):
            if tier == "eager":
                monkeypatch.setenv("TM_TPU_FAST_DISPATCH", "0")
            else:
                monkeypatch.delenv("TM_TPU_FAST_DISPATCH", raising=False)
            dispatch.STATS.reset()
            m = port.classification.MulticlassAccuracy(num_classes=4, nan_policy=policy, device=device)
            m.fast_update = True
            for i, b in enumerate(batches):
                (m.update if i % 2 else m)(*(x.to(device) for x in _ports(b)))
            if tier == "graph":
                logs[policy] = (dispatch.STATS.captures, dispatch.STATS.replays, dict(dispatch.STATS.fallbacks))
            states[(policy, tier)] = {k: v.cpu().numpy().tobytes() for k, v in m._state.tensors.items()}
        assert states[(policy, "graph")] == states[(policy, "eager")], policy
    assert all(log == logs["propagate"] for log in logs.values()), logs
