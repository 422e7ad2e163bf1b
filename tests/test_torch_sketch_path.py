"""``chip_smoke.py``'s path N, the sketches, retrieval's sketch mode and the keyed engine, at a small
size on the CPU.

The functions that drive path N on the card run here on CPU tensors, on the emulated graph tier
(``dispatch.EMULATE_ON_CPU``) and on the eager tier, with their checks: the KLL rank error and exact
count, the count-min state equal to numpy's uint32 hashing, the histogram counts, sketch mode equal
to exact mode on query-aligned batches and to numpy per fragment otherwise, the keyed tables equal
to numpy's, the keyed sketched AUROC equal to plain per-key metrics, and both tiers bit-equal, as on
the card. The file imports no JAX.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from torchmetrics_tpu_torch.ops import dispatch

SMALL = dict(chip_smoke.N_SIZES, n1_bench_batches=3, n1_bench_batch=3000, n1_latency_batches=6, n1_latency_batch=2000,
             n1_cm_batches=4, n1_cm_batch=5000, n1_cm_vocab=20_000, n2_docs=6000, n2_queries=300, n2_aligned_queries=40,
             n2_fixed_batches=4, n2_ragged_docs=3000, n2_ragged_queries=120, n3_keys=(50, 400), n3_batches=4, n3_batch=256,
             n3_stats_keys=300, n3_auroc_keys=7, n3_auroc_bins=64, n3_hist_keys=40,
             n3_quantile_keys=4, n3_quantile_batches=2, n3_quantile_batch=80)
CPU = torch.device("cpu")


def _on_tier(tier: str, monkeypatch) -> None:
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", tier == "graph")
    if tier == "eager":
        monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
    else:
        monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)


def test_countmin_np_is_the_port_s_hash():
    from torchmetrics_tpu_torch.sketch import countmin

    ids = np.concatenate([np.array([0, 1, -1, 2**31 - 1, -(2**31), 2**32 + 5]), np.random.RandomState(0).randint(-10**12, 10**12, 3000)])
    state = countmin.cm_update(countmin.cm_init(), torch.from_numpy(ids))
    np.testing.assert_array_equal(state.numpy(), chip_smoke.countmin_np(ids))


def test_straddled_np_is_the_metric_s():
    """The numpy simulation of sketch mode's straddle count equals the metric's, on batches where the
    sketch over-counts (many ids in a narrow sketch) and where it does not."""
    import torchmetrics_tpu_torch.retrieval as retrieval

    rng = np.random.RandomState(4)
    for n_ids, every in ((3000, 300), (200, 50)):
        ids = np.sort(rng.randint(0, n_ids, 12_000))
        cuts = np.searchsorted(ids, np.arange(0, n_ids + every, every))
        batches = [ids[lo:hi] for lo, hi in zip(cuts[:-1], cuts[1:]) if hi > lo]
        m = retrieval.RetrievalMAP(approx="sketch", device="cpu")
        for b in batches:
            m.update(torch.rand(b.size), torch.randint(0, 2, (b.size,)), indexes=torch.from_numpy(b))
        assert m.straddled_queries == chip_smoke.straddled_np(batches)
    assert chip_smoke.straddled_np(batches) == 0  # 200 ids in 4 x 1,024 cells: no false positive here


def test_stream_hist_np_is_the_metric_s():
    import torchmetrics_tpu_torch as tm

    values = np.random.RandomState(1).lognormal(3, 1, 5000).astype(np.float32)
    m = tm.StreamingHistogram(bins=64, lo=0.0, hi=2000.0, device="cpu")
    m.update(torch.from_numpy(values))
    np.testing.assert_array_equal(m.compute().numpy(), chip_smoke.stream_hist_np(values, 64, 0.0, 2000.0))


def test_n1_on_both_tiers(monkeypatch):
    import torchmetrics_tpu_torch as tm

    data = chip_smoke.path_n1_data(SMALL)
    refs = chip_smoke.path_n1_refs(data)
    cpu = tm.StreamingQuantile(q=(0.5, 0.9, 0.99), device="cpu")
    for batch in torch.from_numpy(data["latencies"]):
        cpu.update(batch)
    results = {}
    for tier in ("graph", "eager"):
        _on_tier(tier, monkeypatch)
        results[tier], lines = chip_smoke.run_path_n1(CPU, tier, data, refs, cpu.metric_state["sketch"])
        assert sorted(lines) == ["StreamingHistogram", "StreamingQuantile bench", "StreamingQuantile latencies", "count-min",
                                 "merge"]
    assert results["graph"] == results["eager"]


def test_n1_fails_on_a_wrong_state(monkeypatch):
    """The check against the CPU's state is live: a state of another stream fails the part."""
    import torchmetrics_tpu_torch as tm

    data = chip_smoke.path_n1_data(SMALL)
    other = tm.StreamingQuantile(device="cpu")
    other.update(torch.from_numpy(data["latencies"][0]))
    _on_tier("eager", monkeypatch)
    with pytest.raises(AssertionError, match="CPU's bits"):
        chip_smoke.run_path_n1(CPU, "eager", data, chip_smoke.path_n1_refs(data), other.metric_state["sketch"])


def test_n2_on_both_tiers(monkeypatch):
    data = chip_smoke.path_n2_data(SMALL)
    results = {}
    for tier in ("graph", "eager"):
        _on_tier(tier, monkeypatch)
        results[tier], lines = chip_smoke.run_path_n2(CPU, tier, data, SMALL)
        assert sorted(lines) == ["aligned", "fixed", "ragged"]
        assert results[tier]["fixed"][1] > 0
        assert sum(v == "raised" for v in results[tier].values()) == 4
    assert results["graph"] == results["eager"]


def test_n3_on_both_tiers(monkeypatch):
    data = chip_smoke.path_n3_data(SMALL)
    refs = chip_smoke.path_n3_refs(CPU, data, SMALL)
    assert refs["quantile"].shape == (SMALL["n3_quantile_keys"], 24, SMALL["n3_quantile_capacity"] + 2)
    assert refs["auroc"][0].shape == (SMALL["n3_auroc_keys"], SMALL["n3_auroc_bins"])
    results = {}
    for tier in ("graph", "eager"):
        _on_tier(tier, monkeypatch)
        results[tier], lines = chip_smoke.run_path_n3(CPU, tier, data, refs, SMALL)
        assert "levels 0-" in lines["StreamingQuantile"]
        assert {"AUROC", "StreamingHistogram", "StreamingQuantile", "Mean, Max, Min"} <= set(lines)
    assert results["graph"] == results["eager"]
