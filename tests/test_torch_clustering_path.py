"""``chip_smoke.py``'s path M, clustering and nominal association, at a small size on the CPU.

The functions that drive path M on the card run here on CPU tensors, on the emulated graph tier
(``dispatch.EMULATE_ON_CPU``) and on the eager tier, with their checks: contingency tables and
confusion matrices equal to numpy's counts, every value within 1e-5 relative of the float64 numpy
side (or its float32 bound), and both tiers bit-equal, as on the card. Also here: the numpy side
held to sklearn's definitions through the JAX-free oracle of ``tests/test_torch_clustering.py``.
The file imports no JAX.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from torchmetrics_tpu_torch.ops import dispatch

SMALL = dict(m1_rows=3000, m1_classes=30, m1_batch=300, m1_stream_rows=20_000, m1_stream_classes=10, m1_stream_batch=2000,
             m2_rows=600, m2_dim=16, m2_clusters=12, m2_batch=100, m3_pairs=20_000, m3_classes=50, m3_batch=2000,
             m3_adult_rows=2000, m3_items=2000, m3_item_batch=200)
CPU = torch.device("cpu")


def _on_tier(tier: str, monkeypatch) -> None:
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", tier == "graph")
    if tier == "eager":
        monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
    else:
        monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)


def test_m1_on_both_tiers(monkeypatch):
    results, refs = {}, None
    for tier in ("graph", "eager"):
        _on_tier(tier, monkeypatch)
        results[tier], lines, refs, errors = chip_smoke.run_path_m1(CPU, tier, SMALL, refs)
        assert sorted(lines) == ["ImageNet-1k val", "stream"]
        assert len(errors) == 2 * 9 + 10
    assert results["graph"] == results["eager"]


def test_m1_numpy_side_against_the_oracle_and_sklearn_definitions():
    """``extrinsic_np``'s EMI equals the test oracle's; its scores follow from it as sklearn defines them."""
    from tests.test_torch_clustering import emi_float64

    preds, target = chip_smoke.path_m1_labels(4000, 25, 31)
    table = chip_smoke.contingency_np(preds, target)
    want = chip_smoke.extrinsic_np(table)
    assert abs(want["expected_mutual_info"] - emi_float64(table)) <= 1e-12 * want["expected_mutual_info"]
    sklearn = pytest.importorskip("sklearn.metrics")
    for key, fn in (("mutual_info", sklearn.mutual_info_score), ("rand", sklearn.rand_score),
                    ("adjusted_rand", sklearn.adjusted_rand_score), ("adjusted_mutual_info", sklearn.adjusted_mutual_info_score),
                    ("normalized_mutual_info", sklearn.normalized_mutual_info_score),
                    ("fowlkes_mallows", sklearn.fowlkes_mallows_score), ("homogeneity", sklearn.homogeneity_score),
                    ("completeness", sklearn.completeness_score), ("v_measure", sklearn.v_measure_score)):
        np.testing.assert_allclose(want[key], fn(target, preds), rtol=1e-10)


def test_m2_on_both_tiers(monkeypatch):
    data = chip_smoke.path_m2_data(SMALL["m2_rows"], SMALL["m2_dim"], SMALL["m2_clusters"])
    want = chip_smoke.intrinsic_np(*data)
    dev = tuple(torch.from_numpy(a) for a in data)
    results = {}
    for tier in ("graph", "eager"):
        _on_tier(tier, monkeypatch)
        results[tier], line, errors = chip_smoke.run_path_m2(CPU, tier, dev, want, SMALL["m2_batch"])
        assert set(errors) == set(chip_smoke.M2_CLASSES)
    assert results["graph"] == results["eager"]


def test_m2_bounds_cover_a_float32_evaluation():
    """Each float32 bound of ``intrinsic_np`` is larger than the error of the port's float32 values
    on data whose clusters are far apart against their spread, and far below the values."""
    import torchmetrics_tpu_torch.functional.clustering as fc

    data, labels = chip_smoke.path_m2_data(2000, 64, 20)
    want = chip_smoke.intrinsic_np(data, labels)
    x, l = torch.from_numpy(data), torch.from_numpy(labels)
    for key, got in (("calinski_harabasz", fc.calinski_harabasz_score(x, l)), ("davies_bouldin", fc.davies_bouldin_score(x, l)),
                     ("dunn_p2", fc.dunn_index(x, l, 2)), ("dunn_p1", fc.dunn_index(x, l, 1))):
        assert abs(float(got) - want[key]) <= want[key + "_bound"], key
        assert want[key + "_bound"] < 1e-3 * abs(want[key]), key


def test_m3_on_both_tiers(monkeypatch):
    refs = chip_smoke.path_m3_refs(SMALL)
    results = {}
    for tier in ("graph", "eager"):
        _on_tier(tier, monkeypatch)
        dispatch.STATS.reset()
        results[tier], lines, errors = chip_smoke.run_path_m3(CPU, tier, refs, SMALL)
        assert sorted(lines) == ["adult", "fleiss", "pairs drop", "pairs replace"]
        if tier == "graph":
            assert dispatch.STATS.captures == 8 and dispatch.STATS.n_fallbacks >= 2  # FleissKappa's list state
    assert results["graph"] == results["eager"]
    assert len(refs["matrices"]["theils_u"]) == len(chip_smoke.ADULT_CARDINALITIES)


def test_m3_numpy_side_against_the_jax_free_definitions():
    """``association_np`` of a 2 x 3 table, worked by hand from the definitions."""
    table = np.array([[10, 0, 5], [2, 8, 5]])
    got = chip_smoke.association_np(table, 9)
    n, rows, cols = 30.0, table.sum(1), table.sum(0)
    chi2 = sum((table[i, j] - rows[i] * cols[j] / n) ** 2 / (rows[i] * cols[j] / n) for i in range(2) for j in range(3))
    np.testing.assert_allclose(got["pearsons_contingency_coefficient"], np.sqrt(chi2 / n / (1 + chi2 / n)), rtol=1e-12)
    phi2c = max(0.0, chi2 / n - 2 / 29)
    np.testing.assert_allclose(got["cramers_v"], np.sqrt(phi2c / min(2 - 1 / 29 - 1, 3 - 4 / 29 - 1)), rtol=1e-12)
