"""The retrieval compute on the graph tier, and against an independent numpy evaluation.

On the CPU, ``dispatch.EMULATE_ON_CPU`` runs the graph tier's bookkeeping: the flat compute is one
graph per padded length (a longer stream in the same power of two replays it), the rectangle path
one per shape, and the values equal the eager tier's. ``chip_smoke.py``'s ragged set (50,000
documents, 1,000 unsorted ids, tied scores, ``ignore_index``, empty queries of both kinds, all ten
metrics, every empty action and aggregation, ``top_k``, ``adaptive_k``) runs here against the numpy
evaluation the card run uses (a sort per query, AP directly, NDCG by sklearn's tie-averaged DCG),
within 1e-5. The ``cuda`` cases hold, on the card, the graph tier equal to the eager tier bit for
bit, two runs bit-equal (the segment sums are deterministic) and one graph per padded length:

    python -m pytest --noconftest tests/test_torch_retrieval_graph.py -m cuda

The file imports no JAX, so it runs where JAX is not installed.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
import torchmetrics_tpu_torch.retrieval as pr
from torchmetrics_tpu_torch.ops import dispatch
from torchmetrics_tpu_torch.ops import segments

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture
def device(request, monkeypatch):
    name = request.param
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph tier captures CUDA graphs")
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)
    dispatch.STATS.reset()
    return torch.device(name, 0) if name == "cuda" else torch.device("cpu")


def _ragged(n: int, n_queries: int, seed: int = 1, graded: bool = False):
    rng = np.random.RandomState(seed)
    indexes = rng.randint(0, n_queries, n)
    preds = (rng.randint(0, 16, n) / 16.0).astype(np.float32)
    target = rng.randint(0, 4 if graded else 2, n)
    target[indexes % 7 == 0] = 0
    target[(rng.rand(n) < 0.1) | (indexes % 11 == 4)] = -1
    return indexes, preds, target


METRICS = {
    "RetrievalMAP": {}, "RetrievalNormalizedDCG": {"top_k": 6}, "RetrievalFallOut": {"top_k": 3},
    "RetrievalMRR": {"aggregation": "median"}, "RetrievalPrecisionRecallCurve": {"max_k": 9, "adaptive_k": True},
    "RetrievalRecall": {"aggregation": lambda v: v.max()},
}


def _run(name: str, device, streams, tier: str, monkeypatch):
    """One metric over the given streams, one update each, then compute; returns the value's bytes."""
    if tier == "eager":
        monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
    else:
        monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)
    m = getattr(pr, name)(ignore_index=-1, device=device, **METRICS[name])
    for indexes, preds, target in streams:
        m.update(torch.from_numpy(preds).to(device), torch.from_numpy(target).to(device),
                 indexes=torch.from_numpy(indexes).to(device))
    value = m.compute()
    return tuple(v.cpu().numpy().tobytes() for v in (value if isinstance(value, tuple) else (value,)))


@pytest.mark.parametrize("device", DEVICES, indirect=True)
@pytest.mark.parametrize("name", sorted(METRICS))
def test_graph_tier_equals_eager_and_repeats(device, name, monkeypatch):
    stream = _ragged(20_000 if device.type == "cuda" else 3_000, 150, graded=name == "RetrievalNormalizedDCG")
    graph = _run(name, device, [stream], "graph", monkeypatch)
    assert dispatch.STATS.captures >= 1 and not dispatch.STATS.fallbacks.get((name, "compute", "capture_failed"))
    assert graph == _run(name, device, [stream], "graph", monkeypatch)
    assert graph == _run(name, device, [stream], "eager", monkeypatch)


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_one_graph_per_padded_length(device, monkeypatch):
    """3,000 and 4,000 documents pad to 4,096 and share a graph; 5,000 pad to 8,192 and capture anew."""
    m = pr.RetrievalMAP(device=device)
    indexes, preds, target = _ragged(5_000, 200)
    target = np.clip(target, 0, 1)
    captures = []
    for lo, hi in ((0, 3_000), (3_000, 4_000), (4_000, 5_000)):
        m.update(torch.from_numpy(preds[lo:hi]).to(device), torch.from_numpy(target[lo:hi]).to(device),
                 indexes=torch.from_numpy(indexes[lo:hi]).to(device))
        value = m.compute()
        captures.append(dispatch.STATS.captures)
        eager = pr.RetrievalMAP(device=device)
        eager.update(torch.from_numpy(preds[:hi]).to(device), torch.from_numpy(target[:hi]).to(device),
                     indexes=torch.from_numpy(indexes[:hi]).to(device))
        monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
        assert torch.equal(value, eager.compute())
        monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)
    assert captures == [1, 1, 2] and dispatch.STATS.replays == 3
    assert not [k for k in dispatch.STATS.fallbacks if k[1] == "compute" and k[2] != "fast_dispatch_env_off"]


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_sorted_segment_sums_repeat_bitwise(device):
    rng = np.random.RandomState(2)
    gid = torch.from_numpy(np.sort(rng.randint(0, 3_000, 200_000))).to(device)
    gid = torch.cumsum(torch.cat([torch.ones(1, dtype=torch.bool, device=device), gid[1:] != gid[:-1]]), 0) - 1
    x = torch.from_numpy(rng.rand(200_000).astype(np.float32)).to(device)
    offsets = segments.segment_offsets(gid, 200_000)
    first = segments.sorted_segment_reduce(x, offsets)
    for _ in range(3):
        assert torch.equal(first, segments.sorted_segment_reduce(x, offsets))
    np.testing.assert_allclose(first.cpu().numpy(), segments.segment_sum(x.cpu(), gid.cpu(), 200_000).numpy(),
                               rtol=1e-5, atol=1e-4)


def test_ragged_set_matches_numpy_on_both_tiers(monkeypatch):
    """``chip_smoke.py``'s ragged set and numpy evaluation, on the CPU at a small size (3,000 documents over 60
    queries; the card runs 50,000 over 1,000): every config agrees within 1e-5, ``"error"`` raises, the graph
    tier captures without a compute fallback and gives the eager tier's bits."""
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    cpu = torch.device("cpu")
    results = {}
    for tier in ("graph", "eager"):
        with chip_smoke.tier(tier):
            results[tier], captures, replays = chip_smoke.run_path_h_ragged(cpu, tier, n=3_000, n_queries=60,
                                                                            split=1_200)
        assert (captures > 0) == (tier == "graph")
    assert results["graph"] == results["eager"]
    assert sum(v == "raised" for v in results["graph"].values()) == 9


def test_numpy_evaluation_is_sklearns():
    """The numpy evaluation of the card run: AP and NDCG equal sklearn's on tie-free queries, and
    the tie-averaged DCG equals sklearn's with ties."""
    from sklearn.metrics import average_precision_score, ndcg_score

    rng = np.random.RandomState(3)
    for _ in range(10):
        scores, rel = rng.rand(25), rng.randint(0, 2, 25).astype(np.float64)
        rel[0] = 1
        assert chip_smoke.query_value_np("RetrievalMAP", scores, rel) == pytest.approx(average_precision_score(rel, scores))
        tied, graded = rng.randint(0, 5, 25) / 5.0, rng.randint(0, 4, 25).astype(np.float64)
        for k in (None, 4):
            want = ndcg_score(graded[None], tied[None], k=k)
            assert chip_smoke.query_value_np("RetrievalNormalizedDCG", tied, graded, top_k=k) == pytest.approx(want)
