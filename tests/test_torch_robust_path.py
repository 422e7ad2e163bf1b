"""``chip_smoke.py``'s path U at a small size on the CPU (the emulated graph tier): U0, the row scan's bounded
graphs over R2's loop and a sweep of more padded shapes than it keeps; U1, every ``nan_policy`` on a poisoned
stream, counts and values against numpy, the tiers bit-equal; U2, snapshots mid-stream of the collection,
``Windowed``, keyed and sketched metrics; U3, two spawned children killed by SIGKILL and recovered bit-equal;
U4, ``plot`` on an Agg canvas or JAX's error without matplotlib. The card runs the same code at full width::

    python3 chip_smoke.py --only U
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from torchmetrics_tpu_torch.ops import dispatch  # noqa: E402

U_SMALL = dict(chip_smoke.U_STREAM, u_classes=12, u_batch=40, u_batches=12, u1_poisoned=3, u1_rate=0.02, u2_cut=5,
               u2_o3_batches=8, u2_o3_batch=64, u2_n3_keys=20, u2_n3_batches=6, u2_n3_batch=64, u2_d_batches=4,
               u2_d_batch=256, u2_d_bins=64, u3_every_k=4, u3_kill_after=7, u3_buffer=2)
#: U0 at a truly small size: 64 short utterances (6 words on average, at most 16) and a sweep of 9 padded
#: shapes, still more than the row scan keeps graphs
U0_SMALL = {"u0_batch": 16, "u0_sweep": (20, 40, 70)}
R_SMALL = dict(chip_smoke.R_SIZES, r2_utterances=64, r2_mean_words=6.0, r2_max_words=16)


@pytest.mark.parametrize("part", ["U0", "U1", "U2", "U3", "U4"])
def test_run_path_u_on_the_cpu(monkeypatch, capsys, part):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    out = chip_smoke.run_path_u(torch.device("cpu"), "cpu", sizes=U_SMALL, parts=(part,), u0_sizes=U0_SMALL,
                                r_sizes=R_SMALL)
    printed = capsys.readouterr().out
    assert out["seconds"] > 0 and f"path {part} [cpu]" in printed
    if part == "U3":
        assert printed.count("bit-equal to the uninterrupted run") == 2
