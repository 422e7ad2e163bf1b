"""``chip_smoke.py`` path K, the regression slice, dry-run on the CPU at a small size.

The same functions that drive path K on the card (K1's 13-metric collection, K2's eight outputs,
K3's rank correlations against scipy, K4's embedding, distillation and claims metrics, K5's ragged
set of all 18 classes and 18 functions) run here on CPU tensors, on the emulated graph tier
(``dispatch.EMULATE_ON_CPU``) and on the eager tier, with their checks against float64 numpy and
scipy; the two tiers must give the same bits, as on the card. The file imports no JAX.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from torchmetrics_tpu_torch.ops import dispatch


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    dispatch.STATS.reset()
    return torch.device("cpu")


def _on_tier(tier: str, monkeypatch) -> None:
    if tier == "eager":
        monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
    else:
        monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)


def test_k1_and_k2_on_both_tiers(cpu, monkeypatch):
    results = {}
    for tier in ("graph", "eager"):
        _on_tier(tier, monkeypatch)
        k1, _, errors = chip_smoke.run_path_k1(cpu, tier, rows=2000, batch=20)
        k2, line, cancel = chip_smoke.run_path_k2(cpu, tier, rows=2000, batch=20)
        results[tier] = (k1, k2)
        assert errors["r2 (all)"] <= 1e-5 and set(cancel) == {"r2_raw", "explained_variance", "r2_weighted"}
    assert dispatch.STATS.captures >= 8
    assert results["graph"] == results["eager"]


def test_k2_bound_covers_the_cancelling_column():
    """The derived float32 bound of the cancelling column holds the error of a float32 moment-sum
    evaluation done here, and is far above the other columns' 1e-5."""
    preds, target = chip_smoke.path_k_data("K2", rows=20_000, batch=200)
    p, t = preds.reshape(-1, 8), target.reshape(-1, 8)
    want = chip_smoke.moments_np(p, t, 100, 200)
    s2 = np.zeros(8, np.float32)
    s1 = np.zeros(8, np.float32)
    rss = np.zeros(8, np.float32)
    for i in range(100):
        ti, pi = target[i], preds[i]
        s2 += (ti * ti).sum(0, dtype=np.float32)
        s1 += ti.sum(0, dtype=np.float32)
        rss += ((ti - pi) ** 2).sum(0, dtype=np.float32)
    n = np.float32(p.shape[0])
    r2 = 1 - rss / (s2 - s1 * (s1 / n))
    c = chip_smoke.K2_CANCEL
    assert abs(float(r2[c]) - want["r2"][c]) <= want["r2_bound"][c]
    assert want["r2_bound"][c] > 100 * want["r2_bound"][0]


def test_k3_against_scipy_on_both_tiers(cpu, monkeypatch):
    results = {}
    for tier in ("graph", "eager"):
        _on_tier(tier, monkeypatch)
        results[tier], line, costs = chip_smoke.run_path_k3(cpu, tier, n_spearman=2000, n_kendall=300)
        assert set(costs) == {"b", "c"}
    assert results["graph"] == results["eager"]


def test_k4_on_both_tiers(cpu, monkeypatch):
    data = chip_smoke.path_k4_data(rows=10, dim=16, classes=20, claims=2000)
    results = {}
    for tier in ("graph", "eager"):
        _on_tier(tier, monkeypatch)
        results[tier], _ = chip_smoke.run_path_k4(cpu, tier, data=data)
    assert results["graph"] == results["eager"]


def test_k5_ragged_set(cpu, monkeypatch):
    """Every class and function of the slice with its edges; here the "card" is the CPU too, so this
    checks the driver itself: shapes, keys, the allowed fallbacks and KL's inf."""
    for tier in ("graph", "eager"):
        _on_tier(tier, monkeypatch)
        values = chip_smoke.run_path_k_ragged(cpu, tier, n=300)
        assert values["R2Score one sample"] == 0.0
    assert len([k for k in values if " batch " not in k]) == len(chip_smoke.K5_CLASSES) + len(chip_smoke.K5_FUNCTIONS) + 1
