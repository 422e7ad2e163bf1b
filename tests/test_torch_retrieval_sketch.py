"""Retrieval's ``approx="sketch"`` mode of the port against the JAX package's.

The cases of the JAX package's ``tests/unittests/sketch/test_retrieval_sketch.py``, each run through
both packages on the same numpy batches: sketch mode equal to exact mode on query-aligned batches
(every scalar class, each aggregation, ``top_k``, ``ignore_index``), the empty metric, straddled
queries and their warning, each empty action (``"error"`` raises at ``update``), FallOut's negative
axis, and the rejections. Values agree within 1e-6 and the straddle counts and count-min states
exactly. Also: ids that differ only above 2^32, which the port keeps as two queries but the sketch
hashes alike, so the straddle count over-counts and never under-counts.
"""
from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.retrieval as pr
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError, TorchMetricsUserWarning

SCALARS = ("RetrievalMAP", "RetrievalMRR", "RetrievalPrecision", "RetrievalRecall", "RetrievalFallOut",
           "RetrievalHitRate", "RetrievalRPrecision", "RetrievalNormalizedDCG")
TOL = 1e-6


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu.retrieval as jr
    from torchmetrics_tpu.utils.exceptions import TorchMetricsUserError as JaxUserError
    from torchmetrics_tpu.utils.exceptions import TorchMetricsUserWarning as JaxUserWarning

    return SimpleNamespace(retrieval=jr, UserError=JaxUserError, UserWarning=JaxUserWarning)


def _batches(n_batches=5, nq=24, seed=0, ensure_pos=True, ignore=False):
    """Query-aligned batches (the JAX test's ``_batches``): every query's documents in one batch."""
    rng = np.random.RandomState(seed)
    out, q0 = [], 0
    for _ in range(n_batches):
        idx, pr_, tg = [], [], []
        for q in range(q0, q0 + nq):
            n = rng.randint(4, 12)
            idx += [q] * n
            pr_ += list(rng.uniform(0, 1, n))
            t = rng.randint(0, 2, n)
            if ensure_pos and t.sum() == 0:
                t[rng.randint(n)] = 1
            if ensure_pos and t.sum() == n:  # keep a negative too (FallOut)
                t[rng.randint(n)] = 0
            tg += list(t)
        q0 += nq
        tg = np.asarray(tg, np.int64)
        if ignore:
            tg[rng.rand(tg.size) < 0.1] = -1
        out.append((np.asarray(pr_, np.float32), tg, np.asarray(idx, np.int64)))
    return out


BATCHES = _batches()


def _feed(metric, batches, torch_side: bool) -> None:
    for p, t, i in batches:
        if torch_side:
            metric.update(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(i))
        else:
            metric.update(p, t, indexes=i)


def _run(jax, name, batches, **kwargs):
    """(port sketch, JAX sketch, port exact), each fed ``batches``."""
    ours = getattr(pr, name)(approx="sketch", device="cpu", **kwargs)
    theirs = getattr(jax.retrieval, name)(approx="sketch", **kwargs)
    exact = getattr(pr, name)(device="cpu", **kwargs)
    _feed(ours, batches, True)
    _feed(theirs, batches, False)
    _feed(exact, batches, True)
    return ours, theirs, exact


def _same_state(ours, theirs) -> None:
    """Counts and the count-min state exactly; the per-query values' aggregates within 1e-6 (a
    query's value may differ from JAX's in its last bit)."""
    for key in ("query_count", "straddled", "query_cms"):
        np.testing.assert_array_equal(ours.metric_state[key].numpy(), np.asarray(theirs.metric_state[key]))
    for key in ("value_sum", "value_min", "value_max"):
        np.testing.assert_allclose(float(ours.metric_state[key]), float(theirs.metric_state[key]), rtol=TOL)


@pytest.mark.parametrize("name", SCALARS)
def test_sketch_matches_exact_and_jax(jax, name):
    ours, theirs, exact = _run(jax, name, BATCHES)
    _same_state(ours, theirs)
    value = float(ours.compute())
    assert abs(value - float(theirs.compute())) <= TOL and abs(value - float(exact.compute())) <= TOL
    assert ours.straddled_queries == theirs.straddled_queries == 0
    assert ours.jit_update is False and ours.scan_update is False


@pytest.mark.parametrize("aggregation", ["mean", "min", "max"])
@pytest.mark.parametrize("name", ["RetrievalMRR", "RetrievalMAP"])
def test_aggregations(jax, name, aggregation):
    ours, theirs, exact = _run(jax, name, BATCHES, aggregation=aggregation)
    value = float(ours.compute())
    assert abs(value - float(theirs.compute())) <= TOL and abs(value - float(exact.compute())) <= TOL


@pytest.mark.parametrize("name", ["RetrievalHitRate", "RetrievalPrecision", "RetrievalNormalizedDCG", "RetrievalFallOut"])
def test_top_k_respected(jax, name):
    ours, theirs, exact = _run(jax, name, BATCHES, top_k=3)
    value = float(ours.compute())
    assert abs(value - float(theirs.compute())) <= TOL and abs(value - float(exact.compute())) <= TOL


@pytest.mark.parametrize("name", ["RetrievalMAP", "RetrievalFallOut"])
def test_ignore_index(jax, name):
    batches = _batches(seed=3, ignore=True)
    ours, theirs, exact = _run(jax, name, batches, ignore_index=-1)
    _same_state(ours, theirs)
    assert abs(float(ours.compute()) - float(exact.compute())) <= TOL


def test_empty_metric_computes_zero(jax):
    ours, theirs = pr.RetrievalMRR(approx="sketch", device="cpu"), jax.retrieval.RetrievalMRR(approx="sketch")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert float(ours.compute()) == float(theirs.compute()) == 0.0


def test_straddled_counted_and_warned(jax):
    ours, theirs = pr.RetrievalMRR(approx="sketch", device="cpu"), jax.retrieval.RetrievalMRR(approx="sketch")
    for _ in range(2):  # every query id appears again
        _feed(ours, BATCHES[:1], True)
        _feed(theirs, BATCHES[:1], False)
    assert ours.straddled_queries == theirs.straddled_queries == 24
    with pytest.warns(TorchMetricsUserWarning, match="more than one update batch"):
        value = ours.compute()
    with pytest.warns(jax.UserWarning, match="more than one update batch"):
        assert abs(float(value) - float(theirs.compute())) <= TOL


def test_disjoint_batches_do_not_straddle():
    sk = pr.RetrievalMRR(approx="sketch", device="cpu")
    _feed(sk, BATCHES, True)
    assert sk.straddled_queries == 0
    assert pr.RetrievalMRR(device="cpu").straddled_queries == 0  # exact mode straddles nothing


def test_unaligned_batches_fragment_as_jax(jax):
    """Fixed cuts through sorted ids: the fragments are scored alone, the straddle count equals JAX's
    and is at least the number of queries a cut splits."""
    rng = np.random.RandomState(5)
    idx = np.sort(rng.randint(0, 60, 900)).astype(np.int64)
    p, t = rng.rand(900).astype(np.float32), rng.randint(0, 2, 900).astype(np.int64)
    batches = [(p[lo:lo + 128], t[lo:lo + 128], idx[lo:lo + 128]) for lo in range(0, 900, 128)]
    ours, theirs, _ = _run(jax, "RetrievalMAP", batches)
    _same_state(ours, theirs)
    cut = sum(int(idx[lo - 1] == idx[lo]) for lo in range(128, 900, 128))
    assert ours.straddled_queries == theirs.straddled_queries >= cut > 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert abs(float(ours.compute()) - float(theirs.compute())) <= TOL


def test_error_action_raises_at_update(jax):
    preds, target, indexes = np.asarray([0.3, 0.2], np.float32), np.asarray([0, 0], np.int64), np.asarray([0, 0])
    with pytest.raises(ValueError, match="no positive"):
        jax.retrieval.RetrievalMRR(empty_target_action="error", approx="sketch").update(preds, target, indexes=indexes)
    with pytest.raises(ValueError, match="no positive"):
        pr.RetrievalMRR(empty_target_action="error", approx="sketch", device="cpu").update(
            torch.from_numpy(preds), torch.from_numpy(target), indexes=torch.from_numpy(indexes))
    with pytest.raises(ValueError, match="no negative"):
        pr.RetrievalFallOut(empty_target_action="error", approx="sketch", device="cpu").update(
            torch.from_numpy(preds), torch.ones(2, dtype=torch.int64), indexes=torch.from_numpy(indexes))


@pytest.mark.parametrize("action", ["skip", "neg", "pos"])
@pytest.mark.parametrize("name", ["RetrievalMRR", "RetrievalFallOut", "RetrievalNormalizedDCG"])
def test_empty_actions_match_exact_and_jax(jax, name, action):
    batches = _batches(ensure_pos=False, seed=7)
    ours, theirs, exact = _run(jax, name, batches, empty_target_action=action)
    _same_state(ours, theirs)
    value = float(ours.compute())
    assert abs(value - float(theirs.compute())) <= TOL and abs(value - float(exact.compute())) <= TOL


def test_forward_and_update_batches_as_jax(jax):
    ours, theirs = pr.RetrievalMAP(approx="sketch", device="cpu"), jax.retrieval.RetrievalMAP(approx="sketch")
    for p, t, i in BATCHES[:3]:
        got = ours(torch.from_numpy(p), torch.from_numpy(t), indexes=torch.from_numpy(i))
        assert abs(float(got) - float(theirs(p, t, indexes=i))) <= TOL
    _same_state(ours, theirs)
    loop = pr.RetrievalMAP(approx="sketch", device="cpu")
    _feed(loop, BATCHES[:2], True)
    stacked = pr.RetrievalMAP(approx="sketch", device="cpu")
    stacked.update_batches(*(torch.from_numpy(np.stack([b[k][:40] for b in BATCHES[:2]])) for k in range(2)),
                           indexes=torch.from_numpy(np.stack([b[2][:40] for b in BATCHES[:2]])))
    ref = pr.RetrievalMAP(approx="sketch", device="cpu")
    _feed(ref, [tuple(x[:40] for x in b) for b in BATCHES[:2]], True)
    for key, value in ref.metric_state.items():
        assert torch.equal(stacked.metric_state[key], value), key


def test_ids_differing_above_2_32_hash_alike():
    """Ids 5 and 5 + 2^32 are two queries in the port (queue C) but share the sketch's buckets: in one
    batch both are scored, one after the other in a later batch counts as straddled (an over-count)."""
    one = torch.tensor([5, 5, 5 + 2**32, 5 + 2**32])
    preds, target = torch.tensor([0.9, 0.1, 0.8, 0.2]), torch.tensor([1, 0, 0, 1])
    sk, exact = pr.RetrievalMAP(approx="sketch", device="cpu"), pr.RetrievalMAP(device="cpu")
    sk.update(preds, target, indexes=one)
    exact.update(preds, target, indexes=one)
    assert float(sk.metric_state["query_count"]) == 2.0 and sk.straddled_queries == 0
    assert abs(float(sk.compute()) - float(exact.compute())) <= TOL
    apart = pr.RetrievalMAP(approx="sketch", device="cpu")
    apart.update(preds[:2], target[:2], indexes=one[:2])
    apart.update(preds[2:], target[2:], indexes=one[2:])
    assert apart.straddled_queries == 1  # no query straddles: the estimate errs high, never low


def test_rejections_as_jax(jax):
    for kwargs in ({"aggregation": "median"}, {"aggregation": lambda v: v.sum()}):
        with pytest.raises(jax.UserError):
            jax.retrieval.RetrievalMRR(approx="sketch", **kwargs)
        with pytest.raises(TorchMetricsUserError):
            pr.RetrievalMRR(approx="sketch", device="cpu", **kwargs)
    for name in ("RetrievalPrecisionRecallCurve", "RetrievalRecallAtFixedPrecision"):
        with pytest.raises(jax.UserError, match="approx='sketch'"):
            getattr(jax.retrieval, name)(approx="sketch")
        with pytest.raises(TorchMetricsUserError, match="approx='sketch'"):
            getattr(pr, name)(approx="sketch", device="cpu")
    with pytest.raises(ValueError, match="`approx`"):
        pr.RetrievalMRR(approx="bogus", device="cpu")
    sk = pr.RetrievalMAP(approx="sketch", device="cpu")
    assert sorted(sk.metric_state) == sorted(jax.retrieval.RetrievalMAP(approx="sketch").metric_state)
