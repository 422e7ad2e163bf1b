"""``chip_smoke.py``'s path O, the online layer and the engine's telemetry, at a small size on the CPU.

The functions that drive path O on the card run here on CPU tensors, on the emulated graph tier
(``dispatch.EMULATE_ON_CPU``) and on the eager tier, with their checks: O1's window value bit-equal
to a fresh twin on three drives and its drift alarm firing once; O2's and O3's window states equal to
numpy's counts and their ``Ema`` states within the float32 bound of numpy's decayed counts, none
truncated; O4's alarms quiet before the shift and firing once each after it, its KLL ring equal to
the stacked merge of its sub-windows, its histogram numpy's and its EWMA band; O5's call, capture,
dispatch and span counts; and both tiers bit-equal where the window is exact, as on the card. The
file imports no JAX.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.ops import dispatch

SMALL = dict(chip_smoke.O_SIZES, o1_batch=64, o1_batches=24, o1_window=2, o1_every=4,
             o2_batches=24, o2_batch=500, o2_bins=64, o2_thresholds=20, o2_window=3, o2_every=4,
             o3_batches=24, o3_batch=300, o3_classes=11, o3_window=3, o3_every=4,
             o4_stationary=24, o4_shifted=12, o4_batch=1000, o4_reference=2, o4_window=4, o4_every=3,
             o4_stock_quiet=False, o5_steps=6, o5_batch=500)
# at 1,000 latencies a batch the KS of O4's shifted window crosses the stock 0.15 by sampling noise
# alone; the full size's stock specs stay under it (chip_smoke.O4_KS_THRESHOLD)


def _on_tier(tier: str, monkeypatch) -> None:
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", tier == "graph")
    if tier == "eager":
        monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
    else:
        monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)


@pytest.fixture(scope="module")
def data_refs():
    data = chip_smoke.path_o_data(SMALL)
    return data, chip_smoke.path_o_refs(data, SMALL)


def test_helpers():
    """``window_slice`` is the JAX tests' ``_window_batches``; ``decayed_np`` the decayed sum; the
    macro accuracy the port's."""
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy

    assert chip_smoke.window_slice(9, 3, 2) == slice(4, 9) and chip_smoke.window_slice(3, 3, 2) == slice(0, 3)
    assert chip_smoke.window_slice(240, 12, 10) == slice(130, 240)
    counts = [np.array([1.0, 2.0]), np.array([3.0, 0.0]), np.array([0.0, 5.0])]
    state, peak = chip_smoke.decayed_np(counts, 0.5)
    np.testing.assert_array_equal(state, [0.25 + 1.5 + 0.0, 0.5 + 0.0 + 5.0])
    np.testing.assert_array_equal(peak, [3.5, 5.5])
    rng = np.random.RandomState(0)
    preds, target = rng.randint(0, 7, 200), rng.randint(0, 6, 200)
    m = MulticlassAccuracy(num_classes=7, device="cpu")
    m.update(torch.from_numpy(preds), torch.from_numpy(target))
    tp, fp, fn = (m.metric_state[k].numpy().astype(np.float64) for k in ("tp", "fp", "fn"))
    assert abs(chip_smoke.macro_accuracy_np(tp, fp, fn) - float(m.compute())) < 1e-6


@pytest.mark.parametrize("part", ["O1", "O2", "O3", "O4", "O5"])
def test_part_on_both_tiers(part, data_refs, monkeypatch):
    data, refs = data_refs
    results = {}
    for t_index, tier in enumerate(("graph", "eager")):
        _on_tier(tier, monkeypatch)
        obs.telemetry.reset()
        clock = 10_000.0 * (t_index + 1)
        if part == "O1":
            results[tier], lines = chip_smoke.run_path_o1("cpu", tier, data, SMALL, clock)
        elif part == "O2":
            twin = chip_smoke.path_o2_twin("cpu", data, SMALL)
            results[tier], lines = chip_smoke.run_path_o2("cpu", tier, data, dict(refs, o2_twin={tier: twin}), SMALL)
        elif part == "O3":
            results[tier], lines = chip_smoke.run_path_o3("cpu", tier, data, refs, SMALL)
        elif part == "O4":
            results[tier], lines = chip_smoke.run_path_o4("cpu", tier, data, refs, SMALL, clock)
        else:
            results[tier], lines = chip_smoke.run_path_o5("cpu", tier, SMALL)
        assert lines and all(isinstance(v, str) for v in lines.values())
    if part != "O5":
        chip_smoke.same_on_both_tiers(f"path {part}", results["graph"], results["eager"])


def test_run_path_o_whole(monkeypatch):
    """The whole path, as ``main`` runs it (both tiers inside), on the CPU: no kernel to count here."""
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    launches = chip_smoke.run_path_o("cpu", "cpu", dict(SMALL, o4_batch=400, o2_batch=200, o1_batches=8))
    assert launches == {"K1": 0, "K2 hist_pair": 0, "K2 sketch_update": 0, "K3 binned_confmat": 0}
