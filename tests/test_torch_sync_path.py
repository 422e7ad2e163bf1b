"""``chip_smoke.py``'s path L at a small size on the CPU: the code the card runs, with the kernels'
plain versions.

L2 runs ``chip_smoke.py --sync-worker`` twice, a gloo world of two CPU processes, each with its share
of every case; the workers hold rank 0's synced values and states to one process's over the whole
data, and the harness holds the two ranks to the same bits. L1 runs a one-rank gloo world in this
process (NCCL needs the card). L3 runs the six wrappers on the emulated graph tier and the eager
tier, held to float64 numpy and to each other bit for bit.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

import chip_smoke
from torchmetrics_tpu_torch.ops import dispatch

CPU = torch.device("cpu")
SMALL = dict(a_rows=2000, a_batch=100, b_rows=400, b_batch=50, b_classes=20, c_rows=2000, c_batch=100, d_batch=512,
             d_batches=4, h_docs=3000, h_split=1700, h_queries=50, p_rows=2000, p_split=700, p_batch=100, k4_rows=400,
             k4_batch=50, k4_dim=16, idle_rows=100)


def test_path_l2_two_gloo_ranks():
    cases, launches, w1 = chip_smoke.run_path_l2(CPU, SMALL)
    assert sorted(cases) == ["A collection", "B collection", "B confusion matrix", "C binned AUROC + AP", "D sketched AUROC",
                             "H MAP", "K1 MSE", "K1 Pearson", "K4 cosine", "idle rank CatMetric"]
    for name, (_, reports, check) in cases.items():
        assert check.startswith("value "), name
        assert all(r["gathers"] >= 1 and r["bytes"] > 0 for r in reports), name
    assert cases["A collection"][1][0]["gathers"] == 16  # four members, four states each, every member syncs
    assert set(launches) == set(chip_smoke.kernel_counters()) and not any(launches.values())  # CPU: no kernel
    # W1 in the same world: the bounded sync gave the unbounded bits (the workers check), graded full on both ranks
    assert w1["grades"] == [["full"] * 5] * 2 and all(r["gathers"] == 16 for r in w1["reports"])
    assert not any(w1["launches"].values())


def test_path_l1_one_rank_world():
    rng = np.random.RandomState(0)
    pa, ta = (torch.from_numpy(rng.randint(0, 5, 2000).astype(np.int32)) for _ in range(2))
    rng = np.random.RandomState(9)
    h = (torch.from_numpy(rng.rand(3000).astype(np.float32)), torch.from_numpy(rng.randint(0, 2, 3000).astype(np.int32)),
         torch.from_numpy(np.sort(rng.randint(0, 50, 3000)).astype(np.int32)))
    line, launches = chip_smoke.run_path_l1(CPU, (pa, ta), h, 100, backend="gloo")
    assert "A collection: bit-equal to no group" in line and "H MAP: bit-equal to no group" in line
    assert launches == 0
    assert not torch.distributed.is_initialized()


def test_path_l3_wrappers_on_both_tiers(monkeypatch):
    rng = np.random.RandomState(0)
    logits = rng.standard_normal((400, 20)).astype(np.float32)
    target = rng.randint(0, 20, 400).astype(np.int64)
    target[rng.rand(400) < 0.05] = -1
    data = chip_smoke.path_l3_data(CPU, logits, target, torch.from_numpy(logits), torch.from_numpy(target), batch_b=50,
                                   rows=20_000, batch=1_000)
    values, cpu_boot = {}, None
    for tier in ("graph", "eager"):
        monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", tier == "graph")
        dispatch.STATS.reset()
        with chip_smoke.tier(tier), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            values[tier], lines, _, cpu_boot = chip_smoke.run_path_l3(CPU, tier, data, cpu_boot)
        assert sorted(lines) == ["BootStrapper", "ClasswiseWrapper", "MetricTracker", "MinMaxMetric", "MultioutputWrapper",
                                 "MultitaskWrapper"]
        if tier == "graph":
            assert dispatch.STATS.replays > 0
    chip_smoke.same_on_both_tiers("path L3", values["graph"], values["eager"])


def test_worker_failure_is_reported(monkeypatch):
    """A rank that fails (here: a size the data cannot take) fails path L2 with the rank's error."""
    bad = dict(SMALL, k4_batch=0)
    with pytest.raises(AssertionError, match="path L2: rank"):
        chip_smoke.run_path_l2(CPU, bad)
