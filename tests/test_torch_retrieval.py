"""The PyTorch port's retrieval metrics against the JAX package's, on the same numpy inputs.

Every functional entry and every class goes through both packages on the CPU: the flat path and
the rectangle path, every ``empty_target_action`` and aggregation, ``top_k``, ``adaptive_k``,
``ignore_index``, ``max_k``, updates in several batches and the tie order. The cases mirror
``tests/unittests/retrieval/test_retrieval.py``; the edge inputs and the errors are in
``tests/test_torch_retrieval_edges.py``. Values agree within 1e-5 (float32 sums in another order),
``top_k`` values exactly, and every input that raises in the JAX package raises in the port.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import torchmetrics_tpu.functional.retrieval as jf
import torchmetrics_tpu.retrieval as jr
import torchmetrics_tpu_torch.functional.retrieval as pf
import torchmetrics_tpu_torch.retrieval as pr

ATOL = 1e-5
TOP_K = ("RetrievalMAP", "RetrievalMRR", "RetrievalPrecision", "RetrievalRecall", "RetrievalFallOut",
         "RetrievalHitRate", "RetrievalNormalizedDCG")
SCALAR = TOP_K + ("RetrievalRPrecision",)
CURVES = ("RetrievalPrecisionRecallCurve", "RetrievalRecallAtFixedPrecision")


def _mean_callable(values):
    return float(np.mean(np.asarray(values)))


def assert_close(ours, theirs) -> None:
    ours = ours if isinstance(ours, tuple) else (ours,)
    theirs = theirs if isinstance(theirs, tuple) else (theirs,)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, equal_nan=True)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _stream(seed: int, n: int = 600, n_queries: int = 25, graded: bool = False, ties: bool = False,
            ignore: bool = True):
    """Sorted query ids with ignore holes, a query with no positives (3), one with no negatives (5)
    and a fully ignored one (7)."""
    r = np.random.RandomState(seed)
    preds = (r.randint(0, 6, n) / 6.0 if ties else r.rand(n)).astype(np.float32)
    target = r.randint(0, 4 if graded else 2, n)
    indexes = np.sort(r.randint(0, n_queries, n))
    target[indexes == 3] = 0
    target[indexes == 5] = 1
    if ignore:
        target[r.rand(n) < 0.15] = -1
        target[indexes == 7] = -1
    return indexes, preds, target


def _pair(name: str, **kwargs):
    return getattr(pr, name)(device="cpu", **kwargs), getattr(jr, name)(**kwargs)


def _feed(ours, theirs, indexes, preds, target, cuts=(0, 170, 420)):
    bounds = list(cuts) + [len(indexes)]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        ours.update(_t(preds[lo:hi]), _t(target[lo:hi]), indexes=_t(indexes[lo:hi]))
        theirs.update(preds[lo:hi], target[lo:hi], indexes=indexes[lo:hi])


def _both_compute(ours, theirs):
    """Both values, or None where the JAX package raises, after the port raised the same error."""
    try:
        want = theirs.compute()
    except ValueError as err:
        with pytest.raises(ValueError, match=re.escape(str(err))):
            ours.compute()
        return None
    return ours.compute(), want


# ------------------------------------------------------------------------------ functional
FUNCTIONAL = ["retrieval_average_precision", "retrieval_reciprocal_rank", "retrieval_precision", "retrieval_recall",
              "retrieval_fall_out", "retrieval_hit_rate", "retrieval_r_precision", "retrieval_normalized_dcg"]


FUNCTIONAL_CASES = [(name, top_k) for name in FUNCTIONAL
                    for top_k in ([None] if name == "retrieval_r_precision" else [None, 1, 4, 40])]


@pytest.mark.parametrize(("name", "top_k"), FUNCTIONAL_CASES)
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_functional_matches_jax(name, top_k, ties):
    r = np.random.RandomState(FUNCTIONAL_CASES.index((name, top_k)) * 2 + ties)
    for n in (1, 7, 20, 33):
        preds = (r.randint(0, 4, n) / 4.0 if ties else r.rand(n)).astype(np.float32)
        target = r.randint(0, 4 if name == "retrieval_normalized_dcg" else 2, n)
        kwargs = {} if top_k is None else {"top_k": top_k}
        assert_close(getattr(pf, name)(_t(preds), _t(target), **kwargs), getattr(jf, name)(preds, target, **kwargs))


@pytest.mark.parametrize("top_k", [None, 2, 9])
@pytest.mark.parametrize("adaptive_k", [False, True])
def test_functional_precision_adaptive_matches_jax(top_k, adaptive_k):
    r = np.random.RandomState(5)
    preds, target = r.rand(6).astype(np.float32), r.randint(0, 2, 6)
    target[0] = 1
    assert_close(pf.retrieval_precision(_t(preds), _t(target), top_k=top_k, adaptive_k=adaptive_k),
                 jf.retrieval_precision(preds, target, top_k=top_k, adaptive_k=adaptive_k))


@pytest.mark.parametrize("max_k", [None, 1, 3, 12])
@pytest.mark.parametrize("adaptive_k", [False, True])
def test_functional_pr_curve_matches_jax(max_k, adaptive_k):
    r = np.random.RandomState(8)
    preds, target = (r.randint(0, 5, 9) / 5.0).astype(np.float32), r.randint(0, 2, 9)
    ours = pf.retrieval_precision_recall_curve(_t(preds), _t(target), max_k=max_k, adaptive_k=adaptive_k)
    theirs = jf.retrieval_precision_recall_curve(preds, target, max_k=max_k, adaptive_k=adaptive_k)
    assert_close(ours, theirs)
    assert ours[2].tolist() == np.asarray(theirs[2]).tolist()


def test_functional_vs_sklearn_cases():
    """The JAX package's own functional cases (``test_retrieval.py:38-80``), held against the port."""
    p = torch.tensor([0.9, 0.8, 0.7, 0.6, 0.5])
    t = torch.tensor([0, 1, 0, 1, 1])
    assert float(pf.retrieval_precision(p, t, top_k=2)) == pytest.approx(0.5)
    assert float(pf.retrieval_recall(p, t, top_k=2)) == pytest.approx(1 / 3)
    assert float(pf.retrieval_reciprocal_rank(p, t)) == pytest.approx(0.5)
    assert float(pf.retrieval_hit_rate(p, t, top_k=1)) == pytest.approx(0.0)
    assert float(pf.retrieval_hit_rate(p, t, top_k=2)) == pytest.approx(1.0)
    assert float(pf.retrieval_fall_out(p, t, top_k=2)) == pytest.approx(0.5)
    assert float(pf.retrieval_r_precision(p, t)) == pytest.approx(1 / 3)
    precisions, recalls, _ = pf.retrieval_precision_recall_curve(p[:4], torch.tensor([0, 1, 1, 0]), max_k=4)
    np.testing.assert_allclose(precisions.numpy(), [0.0, 0.5, 2 / 3, 0.5], atol=1e-6)
    np.testing.assert_allclose(recalls.numpy(), [0.0, 0.5, 1.0, 1.0], atol=1e-6)
    from sklearn.metrics import average_precision_score, ndcg_score

    r = np.random.RandomState(21)
    for _ in range(5):
        preds, target = r.rand(20).astype(np.float32), r.randint(0, 2, 20)
        graded = r.randint(0, 4, 20)
        if target.sum():
            assert float(pf.retrieval_average_precision(_t(preds), _t(target))) == pytest.approx(
                average_precision_score(target, preds), abs=1e-6)
        assert float(pf.retrieval_normalized_dcg(_t(preds), _t(graded), top_k=5)) == pytest.approx(
            ndcg_score(graded[None], preds[None], k=5), abs=1e-5)


@pytest.mark.parametrize("case", ["shape", "int_preds", "non_binary", "top_k", "adaptive_k", "max_k"])
def test_functional_raises_where_jax_raises(case):
    preds, target = np.array([0.2, 0.3, 0.5], np.float32), np.array([0, 1, 1])
    calls = {
        "shape": ("retrieval_average_precision", (preds, target[:2]), {}),
        "int_preds": ("retrieval_recall", (np.array([1, 2, 3]), target), {}),
        "non_binary": ("retrieval_hit_rate", (preds, np.array([0, 2, 1])), {}),
        "top_k": ("retrieval_precision", (preds, target), {"top_k": 0}),
        "adaptive_k": ("retrieval_precision", (preds, target), {"adaptive_k": 1}),
        "max_k": ("retrieval_precision_recall_curve", (preds, target), {"max_k": -2}),
    }
    name, args, kwargs = calls[case]
    with pytest.raises(ValueError):
        getattr(jf, name)(*args, **kwargs)
    with pytest.raises(ValueError):
        getattr(pf, name)(*(_t(a) for a in args), **kwargs)


# ------------------------------------------------------------------------------ classes
@pytest.mark.parametrize("name", SCALAR + CURVES)
@pytest.mark.parametrize("action", ["neg", "pos", "skip", "error"])
def test_class_every_action_matches_jax(name, action):
    graded = name == "RetrievalNormalizedDCG"
    kwargs = {"empty_target_action": action, "ignore_index": -1}
    if name in TOP_K:
        kwargs["top_k"] = 3
    if name in CURVES:
        kwargs["max_k"] = 5
    indexes, preds, target = _stream(77, graded=graded)
    if action == "error":  # one stream with an empty query, one without
        ours, theirs = _pair(name, **kwargs)
        _feed(ours, theirs, indexes, preds, target)
        assert _both_compute(ours, theirs) is None
        keep = np.isin(indexes, [3, 7], invert=True)
        if name == "RetrievalFallOut":  # empties on missing negatives
            keep &= np.isin(indexes, np.unique(indexes[target == 0]))
        indexes, preds, target = indexes[keep], preds[keep], target[keep]
    ours, theirs = _pair(name, **kwargs)
    _feed(ours, theirs, indexes, preds, target)
    assert_close(*_both_compute(ours, theirs))


@pytest.mark.parametrize("name", SCALAR + ("RetrievalPrecisionRecallCurve",))
@pytest.mark.parametrize("aggregation", ["median", "min", "max", "callable"])
def test_class_every_aggregation_matches_jax(name, aggregation):
    graded = name == "RetrievalNormalizedDCG"
    agg = _mean_callable if aggregation == "callable" else aggregation
    kwargs = {"aggregation": agg, "ignore_index": -1}
    if name in TOP_K:
        kwargs["top_k"] = 4
    indexes, preds, target = _stream(3, graded=graded, ties=True)
    ours, theirs = _pair(name, **kwargs)
    _feed(ours, theirs, indexes, preds, target)
    assert_close(*_both_compute(ours, theirs))


@pytest.mark.parametrize("name", TOP_K)
@pytest.mark.parametrize("top_k", [None, 1, 2, 50])
def test_class_top_k_matches_jax(name, top_k):
    indexes, preds, target = _stream(11, graded=name == "RetrievalNormalizedDCG", ties=True, ignore=False)
    ours, theirs = _pair(name, top_k=top_k)
    _feed(ours, theirs, indexes, preds, target)
    assert_close(*_both_compute(ours, theirs))


@pytest.mark.parametrize("top_k", [None, 2, 30])
@pytest.mark.parametrize("aggregation", ["mean", "callable"])
def test_precision_adaptive_k_matches_jax(top_k, aggregation):
    agg = _mean_callable if aggregation == "callable" else aggregation
    indexes, preds, target = _stream(12)
    ours, theirs = _pair("RetrievalPrecision", top_k=top_k, adaptive_k=True, ignore_index=-1, aggregation=agg)
    _feed(ours, theirs, indexes, preds, target)
    assert_close(*_both_compute(ours, theirs))


@pytest.mark.parametrize("max_k", [None, 1, 7, 140])
@pytest.mark.parametrize("adaptive_k", [False, True])
def test_curves_max_k_matches_jax(max_k, adaptive_k):
    """``max_k=None`` reads the longest valid query; 140 crosses a 128-wide tile of k."""
    indexes, preds, target = _stream(13, n=700, n_queries=5)
    for name in CURVES:
        kwargs = {"max_k": max_k, "adaptive_k": adaptive_k, "ignore_index": -1}
        if name == "RetrievalRecallAtFixedPrecision":
            kwargs["min_precision"] = 0.4
        ours, theirs = _pair(name, **kwargs)
        _feed(ours, theirs, indexes, preds, target)
        got, want = _both_compute(ours, theirs)
        assert_close(got, want)
        assert got[-1].tolist() == np.asarray(want[-1]).tolist()


@pytest.mark.parametrize("min_precision", [0.0, 0.5, 1.0])
def test_recall_at_fixed_precision_matches_jax(min_precision):
    indexes, preds, target = _stream(14, ignore=False)
    ours, theirs = _pair("RetrievalRecallAtFixedPrecision", min_precision=min_precision, max_k=6)
    _feed(ours, theirs, indexes, preds, target)
    got, want = _both_compute(ours, theirs)
    assert_close(got, want)
    assert int(got[1]) == int(want[1])


@pytest.mark.parametrize("name", SCALAR)
@pytest.mark.parametrize("action", ["neg", "pos", "skip"])
def test_rectangle_path_matches_jax(name, action):
    """The rectangle path (``_grouped_aggregate``) of both packages on the same state, and the
    port's flat path beside it (``test_flat_engine_matches_rectangle_path``)."""
    empty_from = "neg" if name == "RetrievalFallOut" else "pos"
    kwargs = {"empty_target_action": action, "ignore_index": -1}
    if name in TOP_K:
        kwargs["top_k"] = 3
    indexes, preds, target = _stream(77, graded=name == "RetrievalNormalizedDCG")
    ours, theirs = _pair(name, **kwargs)
    _feed(ours, theirs, indexes, preds, target)
    rect = ours._grouped_aggregate(*ours._state_arrays(ours._computable_state()), empty_from, "no target")
    want = theirs._grouped_aggregate(*theirs._state_arrays(theirs._computable_state()), empty_from, "no target")
    assert_close(rect, want)
    assert float(ours.compute()) == pytest.approx(float(rect), abs=1e-6)


@pytest.mark.parametrize("name", ["RetrievalMAP", "RetrievalMRR", "RetrievalPrecision", "RetrievalRecall",
                                  "RetrievalHitRate"])
def test_tie_order_matches_rectangle_and_jax(name):
    """Heavily tied scores rank alike in both engines of the port and in the JAX package
    (``test_flat_engine_tie_order_matches_rectangle``, ``test_retrieval.py:275``)."""
    r = np.random.RandomState(11)
    n, q = 80, 6
    preds = (r.randint(0, 4, n) / 4.0).astype(np.float32)
    target = r.randint(0, 2, n)
    indexes = np.sort(r.randint(0, q, n))
    kwargs = {} if name == "RetrievalMAP" else {"top_k": 3}
    ours, theirs = _pair(name, **kwargs)
    _feed(ours, theirs, indexes, preds, target, cuts=(0,))
    flat = ours.compute()
    rect = ours._grouped_aggregate(*ours._state_arrays(ours._computable_state()), "pos", "no target")
    assert float(flat) == pytest.approx(float(rect), abs=1e-6)
    assert_close(flat, theirs.compute())


def test_ranked_target_reverses_input_order_on_ties():
    """Equal scores come out in reversed input order, as ``jnp.argsort(...)[::-1]`` gives them."""
    from torchmetrics_tpu.functional.retrieval._kernels import _ranked_target as jax_ranked
    from torchmetrics_tpu_torch.functional.retrieval._kernels import _ranked_target

    preds = np.array([0.5, 0.5, 0.1, 0.5, -0.0, 0.0, np.nan, 0.5], np.float32)
    target = np.arange(8, dtype=np.float32)
    mask = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)
    got = _ranked_target(_t(preds), _t(target), _t(mask)).numpy()
    assert got.tolist() == np.asarray(jax_ranked(preds, target, mask)).tolist()
