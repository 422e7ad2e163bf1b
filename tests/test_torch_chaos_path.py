"""``chip_smoke.py``'s path W at a small size on the CPU: the code the card runs, with the kernels' plain
versions. W2 (two ``SimWorld`` ranks of path A's collection over 20,000 rows, rank 1 down at ``compute``: the
quorum counts ``np.bincount``'s x 2 exactly, the unrescaled and local values rank 0's, strict mode's
``SyncTimeoutError`` and its one bundle, the healed world one process's bits, the flapping rank evicted and
re-admitted) on the emulated graph tier and the eager tier, bit-equal; W3 (``ChaosRunner`` with the four
injectors over the five aggregators, every scenario once) likewise. W1 runs inside path L2's world
(``tests/test_torch_sync_path.py``). One ``cuda`` test runs W2's quorum arithmetic on the card.
"""
from __future__ import annotations

import pytest
import torch

import chip_smoke
from torchmetrics_tpu_torch.ops import dispatch

CPU = torch.device("cpu")
#: W at a small size: 20,000 of path A's rows in batches of 1,000, the W3 runners' batches of 256, and backoff
#: pauses from 1 ms (W2's time on the card is mostly its jittered retry pauses)
W_SMALL = dict(chip_smoke.W_SIZES, a_rows=20_000, a_batch=1_000, w3_batch=256, backoff_s=0.001)


@pytest.fixture
def emulated(monkeypatch):
    """The graph tier emulated on the CPU (``chip_smoke.tier("graph")`` leaves it to the card otherwise)."""
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)


def test_path_w2_on_both_tiers(emulated, capsys):
    res = chip_smoke.run_path_w(CPU, "cpu", W_SMALL, parts=("W2",))
    out = capsys.readouterr().out
    assert out.count("path W2 [cpu]") == 2 and "graded quorum" in out and "one valid bundle" in out
    assert set(res["launches"]) == set(chip_smoke.kernel_counters()) and not any(res["launches"].values())


def test_path_w3_runners_and_scenarios(emulated, capsys):
    res = chip_smoke.run_path_w(CPU, "cpu", W_SMALL, parts=("W3",))
    out = capsys.readouterr().out
    assert out.count("path W3 [cpu]") == 2 and "scenarios passed" in out
    graph_line = out.split("eager tier")[0]
    assert "AotCompileFailure" in graph_line and "SumMetric forward" in graph_line and not any(res["launches"].values())


@pytest.mark.cuda
def test_w2_quorum_arithmetic_on_the_card():
    """On the card: W2 at 20,000 rows on the graph tier (the quorum rescale of the int64 counts, the grades, the
    bundle, the heal and the flap). Run there with ``python -m pytest --noconftest tests/test_torch_chaos_path.py
    -m cuda``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torchmetrics_tpu_torch.ops import _build

    _build.build(["bincount"])
    res = chip_smoke.run_path_w2(torch.device("cuda", 0), "card", "graph", W_SMALL)
    assert set(res["values"]) == {"quorum", "quorum_exact", "local", "full"}
