"""The PyTorch port's retrieval metrics against the JAX package's on edge inputs and on inputs that
must raise, on the same numpy inputs.

The edge inputs: ``-0.0``/``+0.0`` ties, NaN scores, negative and unsorted query ids, a single
document, every document ignored, a length that is a power of two, and valid scores below the
ignored documents' ``-1e30``; float64 and float16 scores; the empty state; and the constructor,
``update`` and sketch-mode errors. Values agree within 1e-5, and every input that raises in the JAX
package raises in the port. The helpers are ``tests/test_torch_retrieval.py``'s.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import torchmetrics_tpu.retrieval as jr
import torchmetrics_tpu_torch.retrieval as pr
from tests.test_torch_retrieval import CURVES, SCALAR, TOP_K, _both_compute, _feed, _mean_callable, _pair, _stream, _t, assert_close
from torchmetrics_tpu.utils.exceptions import TorchMetricsUserError as JaxUserError
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError


# ------------------------------------------------------------------------------ edge inputs
def _edge(case: str):
    r = np.random.RandomState(4)
    n = 37
    indexes = np.sort(r.randint(0, 6, n))
    preds = r.rand(n).astype(np.float32)
    target = r.randint(0, 2, n)
    if case == "signed_zero_ties":
        preds = np.where(r.rand(n) < 0.5, -0.0, 0.0).astype(np.float32)
    elif case == "nan_scores":
        preds[r.rand(n) < 0.3] = np.nan
    elif case == "negative_ids":
        indexes = indexes - 3
    elif case == "unsorted_ids":
        indexes = r.permutation(indexes)
    elif case == "single_document":
        indexes, preds, target = indexes[:1], preds[:1], np.ones(1, np.int64)
    elif case == "all_ignored":
        target = np.full(n, -1)
    elif case == "power_of_two_length":
        indexes, preds, target = indexes[:32], preds[:32], target[:32]
    elif case == "extreme_scores":  # valid docs below the ignored ones' -1e30
        preds[::5] = -np.inf
        preds[1::7] = -3e38
        target[2::3] = -1
    return indexes, preds, target


EDGES = ["signed_zero_ties", "nan_scores", "negative_ids", "unsorted_ids", "single_document", "all_ignored",
         "power_of_two_length", "extreme_scores"]


@pytest.mark.parametrize("case", EDGES)
@pytest.mark.parametrize("aggregation", ["mean", "callable"])
def test_edge_inputs_match_jax(case, aggregation):
    agg = _mean_callable if aggregation == "callable" else aggregation
    indexes, preds, target = _edge(case)
    for name in SCALAR + ("RetrievalPrecisionRecallCurve",):
        kwargs = {"ignore_index": -1, "aggregation": agg}
        if name in TOP_K:
            kwargs["top_k"] = 3
        if name == "RetrievalPrecisionRecallCurve":
            kwargs["max_k"] = 4
        ours, theirs = _pair(name, **kwargs)
        _feed(ours, theirs, indexes, preds, target, cuts=(0,))
        assert_close(*_both_compute(ours, theirs))


@pytest.mark.parametrize("dtype", [np.float64, np.float16])
def test_score_dtypes_match_jax(dtype):
    """float64 scores are held as float32, as the JAX package holds them with 64-bit mode off;
    float16 scores stay float16 (ignored docs score -inf there, in both packages)."""
    indexes, preds, target = _stream(15, ties=True)
    for name in ("RetrievalMAP", "RetrievalNormalizedDCG"):
        ours, theirs = _pair(name, ignore_index=-1)
        _feed(ours, theirs, indexes, preds.astype(dtype), target)
        assert_close(*_both_compute(ours, theirs))


def test_empty_state_computes_zero_as_jax():
    for name in SCALAR + CURVES:
        ours, theirs = _pair(name, **({"min_precision": 0.5} if name == "RetrievalRecallAtFixedPrecision" else {}))
        with pytest.warns(UserWarning):
            got = ours.compute()
        assert_close(got, theirs.compute())
    # min_precision 0 selects k from the empty curve's 0-d arrays: both packages raise
    ours, theirs = _pair("RetrievalRecallAtFixedPrecision")
    for metric in (ours, theirs):
        with warnings.catch_warnings(), pytest.raises(IndexError):
            warnings.simplefilter("ignore")  # the compute-before-update warning
            metric.compute()


@pytest.mark.parametrize("case", ["shape", "float_ids", "bool_ids", "int_preds", "none"])
def test_update_raises_where_jax_raises(case):
    preds, target, indexes = np.array([0.2, 0.3], np.float32), np.array([0, 1]), np.array([0, 0])
    args = {"shape": (preds, target[:1], indexes), "float_ids": (preds, target, indexes.astype(np.float32)),
            "bool_ids": (preds, target, indexes.astype(bool)), "int_preds": (np.array([1, 2]), target, indexes),
            "none": (preds, target, None)}[case]
    ours, theirs = _pair("RetrievalMAP")
    with pytest.raises(ValueError):
        theirs.update(args[0], args[1], indexes=args[2])
    with pytest.raises(ValueError):
        ours.update(*(None if a is None else _t(a) for a in args[:2]), indexes=None if args[2] is None else _t(args[2]))


def test_non_binary_target_raises_in_update():
    """The port checks the target in ``update``, outside any graph, as the reference does. The JAX
    package's jitted update skips that check (ROADMAP.md, queue C), so only the port raises."""
    ours, theirs = _pair("RetrievalMAP")
    theirs.update(np.array([0.2, 0.3], np.float32), np.array([0, 2]), indexes=np.array([0, 0]))
    with pytest.raises(ValueError, match="binary"):
        ours.update(torch.tensor([0.2, 0.3]), torch.tensor([0, 2]), indexes=torch.tensor([0, 0]))
    graded = pr.RetrievalNormalizedDCG(device="cpu")
    graded.update(torch.tensor([0.2, 0.3]), torch.tensor([0, 2]), indexes=torch.tensor([0, 0]))
    ignored = pr.RetrievalMAP(ignore_index=5, device="cpu")
    ignored.update(torch.tensor([0.2, 0.3]), torch.tensor([5, 1]), indexes=torch.tensor([0, 0]))


@pytest.mark.parametrize("kwargs", [{"empty_target_action": "bogus"}, {"ignore_index": 1.5}, {"aggregation": "sum"},
                                    {"approx": "kll"}, {"top_k": 0}, {"top_k": 2.0}])
def test_constructor_raises_where_jax_raises(kwargs):
    with pytest.raises(ValueError):
        jr.RetrievalMAP(**kwargs)
    with pytest.raises(ValueError):
        pr.RetrievalMAP(device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [{"max_k": 0}, {"adaptive_k": "yes"}, {"min_precision": 2.0}, {"min_precision": 1}])
def test_curve_constructor_raises_where_jax_raises(kwargs):
    with pytest.raises(ValueError):
        jr.RetrievalRecallAtFixedPrecision(**kwargs)
    with pytest.raises(ValueError):
        pr.RetrievalRecallAtFixedPrecision(device="cpu", **kwargs)


def test_sketch_mode_is_not_ported_yet():
    """Sketch mode is ported now (``tests/test_torch_retrieval_sketch.py``): it builds JAX's states,
    and the aggregations it cannot keep are still refused."""
    assert sorted(pr.RetrievalMAP(approx="sketch", device="cpu").metric_state) == sorted(
        jr.RetrievalMAP(approx="sketch").metric_state)
    for kwargs in ({"aggregation": "median"}, {"aggregation": _mean_callable}):
        with pytest.raises(JaxUserError):
            jr.RetrievalMAP(approx="sketch", **kwargs)
        with pytest.raises(TorchMetricsUserError):
            pr.RetrievalMAP(approx="sketch", device="cpu", **kwargs)


def test_forward_matches_jax():
    """``forward`` returns each batch's own value and accumulates the stream."""
    indexes, preds, target = _stream(16)
    for name in ("RetrievalMAP", "RetrievalNormalizedDCG", "RetrievalFallOut"):
        ours, theirs = _pair(name, ignore_index=-1)
        for lo, hi in ((0, 250), (250, 600)):
            sl = slice(lo, hi)
            assert_close(ours(_t(preds[sl]), _t(target[sl]), indexes=_t(indexes[sl])),
                         theirs(preds[sl], target[sl], indexes=indexes[sl]))
        assert_close(ours.compute(), theirs.compute())
        ours.reset()
        theirs.reset()
        _feed(ours, theirs, indexes[:300], preds[:300], target[:300], cuts=(0,))
        assert_close(ours.compute(), theirs.compute())
