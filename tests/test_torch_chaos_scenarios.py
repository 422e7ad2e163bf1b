"""The port's serve and online chaos scenarios (``robust/chaos.py``) against the JAX package's results.

``serve_preempt_mid_overlap``, ``serve_drain_death``, ``serve_queue_overflow``, ``serve_oscillating_load`` and
``online_window_preemption`` run once in each package with JAX's matrix seeding (seed 1234, ``SumMetric``, 6
batches, ``via="update"``). Their result dicts must be equal, less the keys that depend on thread timing in both
packages (the block-mode stall count, the controller's transition, shed and escalation counts, whose verdicts are
compared instead) and less JAX's sharded variant, which waits for the shard (ROADMAP.md, queue A, item 9c); every
value the factory's metrics computed must equal JAX's in order, bit for bit (JAX's sharded variant computes after
them). JAX imports stay inside fixtures.
"""
from __future__ import annotations

import pytest

import torchmetrics_tpu_torch as port
from torchmetrics_tpu_torch.parallel import sync as sync_mod
from torchmetrics_tpu_torch.robust import chaos
from torch_chaos_cases import comparable, run_scenario

SCENARIOS = ["serve_preempt_mid_overlap", "serve_drain_death", "serve_queue_overflow", "serve_oscillating_load",
             "online_window_preemption"]


@pytest.fixture(scope="module")
def jax_results():
    pytest.importorskip("jax")
    import torchmetrics_tpu.parallel.sync as jsync
    import torchmetrics_tpu.robust.chaos as jchaos
    from torchmetrics_tpu.aggregation import SumMetric as JaxSum

    return {name: run_scenario(jchaos, jsync, name, JaxSum) for name in SCENARIOS}


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_matches_jax(jax_results, name):
    """``passed``, the preemption and kill steps, the drop, replay and shed counts, the trace verdicts, the
    bit-identity verdicts of each variant, and every value computed equal JAX's on the same seed and factory."""
    ours, our_values = run_scenario(chaos, sync_mod, name, lambda: port.SumMetric(device="cpu"))
    theirs, their_values = jax_results[name]
    assert ours["passed"] is True and theirs["passed"] is True
    assert comparable(name, ours) == comparable(name, theirs)
    assert {"plain", "keyed"} <= set(ours) and "sharded" in theirs and "sharded" not in ours
    # JAX's values past the port's are its sharded variant's
    computes = name in ("serve_preempt_mid_overlap", "serve_drain_death", "serve_queue_overflow")
    assert len(our_values) <= len(their_values) and (len(our_values) > 0) == computes
    for a, b in zip(our_values, their_values):
        assert a.shape == b.shape and a.tobytes() == b.astype(a.dtype).tobytes()
