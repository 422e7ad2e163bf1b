"""``chip_smoke.py``'s path V at a small size on the CPU (the emulated graph tier, then the eager tier): V1 the
JAX package's serving scenario (paired windows, Poisson arrivals, a preempted journaled run, an overload shed
lane, the controller against a static twin), V2 path B's stream through the collection's engine against the
synchronous bits, V3 its faults and the compute-after-quiesce check, V4 traces and bundles (the bundle CLI in a
subprocess on the first tier). The card runs the same code at full size::

    python3 chip_smoke.py --only V
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from torchmetrics_tpu_torch.ops import dispatch  # noqa: E402

V_SMALL = dict(chip_smoke.V_SIZES, v1_batch=64, v1_batches=16, v1_poisson=24, v1_windows=2, v1_passes=1,
               v1_overload=12, v1_overload_inflight=4, v1_square=24, v3_death_at=3, v3_windows=4, v4_batches=3)
U_SMALL = dict(chip_smoke.U_STREAM, u_classes=10, u_batch=32, u_batches=8)


@pytest.mark.parametrize("part", ["V1", "V2", "V3", "V4"])
def test_run_path_v_on_the_cpu(monkeypatch, capsys, part):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    out = chip_smoke.run_path_v(torch.device("cpu"), "cpu", sizes=U_SMALL, v_sizes=V_SMALL, parts=(part,))
    printed = capsys.readouterr().out
    assert out["seconds"] > 0 and out["K1"] == 0
    for tier_name in ("graph", "eager"):
        assert f"path {part} [cpu] {tier_name} tier" in printed
    if part == "V2":
        assert printed.count("bits the synchronous run's") == 2
    if part == "V4":
        assert "CLI exit codes [0, 1]" in printed


def test_v2_counts_on_the_emulated_graph_tier(monkeypatch):
    """V2's bookkeeping: one replay a window, at most 5 captures (widths 1, 2, 4, 8, 16), the widths powers of
    two summing to the batches served."""
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    logits, target = chip_smoke.path_u_data(U_SMALL)
    batches = chip_smoke._u_batches(logits, target, U_SMALL)
    want = chip_smoke.v2_reference(torch.device("cpu"), batches, U_SMALL)[0]
    with chip_smoke.tier("graph"):
        res = chip_smoke.run_path_v2(torch.device("cpu"), "cpu", "graph", batches, want, U_SMALL)
    assert res["replays"] == len(res["widths"]) and res["captures"] <= 5
    assert sum(res["widths"]) == len(batches) - 1
    assert all(w & (w - 1) == 0 for w in res["widths"])


def test_capture_mode_probe_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    out = chip_smoke.probe_capture_modes(torch.device("cpu"), "cpu", U_SMALL)
    assert len(out) == 4 and all(r["bits_equal"] and not r["broken"] and not r["errors"] for r in out.values())
    assert dispatch.CAPTURE_ERROR_MODE == "thread_local"
