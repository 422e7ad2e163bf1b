"""The port's chaos core (``robust/chaos.py``) against the JAX package's ``tests/unittests/robust/test_chaos.py``
contract, and the sync and journal scenarios against JAX's results.

Every injected fault recovers, or degrades with an explicit signal, to state bit-identical with the unfaulted
run for sum, mean, max, min and cat reductions: a failed graph capture (``AotCompileFailure``: the key latches
broken and the step runs eagerly), a graph step that dies after writing its static buffers (``DonationHazard``:
the metric resets to its defaults with the "failed mid-flight" warning and ``ChaosRunner`` replays the step), a
preemption between steps, and NaN-poisoned batches under ``nan_policy="mask"``. The graph-tier injectors run on
the emulated graph tier (``dispatch.EMULATE_ON_CPU``). ``NaNPoison`` draws the same elements as JAX's for a seed.

The scenarios ``rank_death_quorum_rejoin``, ``preemption_journal_replay``, ``keyed_preemption_journal``,
``sketch_preemption_journal`` and ``flap_evict_readmit`` run once in each package with JAX's matrix seeding
(seed 1234, ``SumMetric``, 6 batches, ``via="update"``); their result dicts and every value the factory's metrics
computed must be equal (``tests/test_torch_chaos_scenarios.py`` holds the serve and online scenarios). JAX
imports stay inside fixtures.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as port
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.ops import dispatch
from torchmetrics_tpu_torch.parallel import sync as sync_mod
from torchmetrics_tpu_torch.robust import chaos
from torchmetrics_tpu_torch.utils.exceptions import NumericPoisonError
from torch_chaos_cases import comparable, run_scenario

SEED = int(os.environ.get(chaos.ENV_CHAOS_SEED, chaos.DEFAULT_SEED))
FXES = ["sum", "mean", "max", "min"]
SCENARIOS = ["rank_death_quorum_rejoin", "preemption_journal_replay", "keyed_preemption_journal",
             "sketch_preemption_journal", "flap_evict_readmit"]


class _ReduceProbe(Metric):
    """A probe with a configurable reduction (JAX ``test_chaos.py:24``): drives every merge of the graph tier
    the injectors target."""

    full_state_update = False

    def __init__(self, fx: str, **kwargs):
        kwargs.setdefault("device", "cpu")
        super().__init__(**kwargs)
        init = {"sum": 0.0, "mean": 0.0, "max": -float("inf"), "min": float("inf")}[fx]
        self.add_state("acc", torch.tensor(init, dtype=torch.float32), dist_reduce_fx=fx)
        self.add_state("count", torch.tensor(0.0), dist_reduce_fx="sum")
        self._fx = fx

    def _update(self, state, value):
        if self._fx == "max":
            acc = torch.maximum(state["acc"], torch.max(value))
        elif self._fx == "min":
            acc = torch.minimum(state["acc"], torch.min(value))
        elif self._fx == "mean":
            acc = state["acc"] + torch.mean(value)
        else:
            acc = state["acc"] + torch.sum(value)
        return {"acc": acc, "count": state["count"] + 1.0}

    def _compute(self, state):
        return state["acc"]


def _batches(n=7, seed=SEED):
    rng = np.random.RandomState(seed % (2**31))
    return [(rng.randn(12).astype(np.float32),) for _ in range(n)]


def _state_bytes(m):
    return {
        **{k: chaos._bytes(v) for k, v in m._state.tensors.items()},
        **{k: tuple(chaos._bytes(e) for e in v) for k, v in m._state.lists.items()},
    }


def _assert_identical(faulted, clean):
    assert _state_bytes(faulted) == _state_bytes(clean)
    assert chaos._bytes(faulted.compute()) == chaos._bytes(clean.compute())
    assert faulted.update_count == clean.update_count


@pytest.fixture
def graph_tier(monkeypatch):
    """The emulated graph tier: CPU tensors take the captures and replays the injectors patch."""
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)


@pytest.mark.parametrize("via", ["forward", "update"])
def test_aot_compile_failure_latches_eager_and_recovers(graph_tier, via):
    """Through ``forward`` (the graph tier) the injected capture failure fires at the fault step, the key
    latches broken (a ``capture_failed`` fallback), no step is replayed, and the stream ends bit-identical with
    the unfaulted run, for every reduction. The probe's ``update`` is eager (it does not ask for
    ``fast_update``), so there the injector finds no capture and does not fire."""
    for fx in FXES:
        batches = _batches()
        runner = chaos.ChaosRunner(lambda: _ReduceProbe(fx), seed=SEED)
        step = runner.pick_fault_step(len(batches))
        injector = chaos.AotCompileFailure()
        latched = dispatch.STATS.fallbacks[("_ReduceProbe", "forward", "capture_failed")]
        faulted = runner.run(batches, injector=injector, fault_steps=[step], via=via)
        clean = chaos.ChaosRunner(lambda: _ReduceProbe(fx), seed=SEED).run(batches, via=via)
        assert (injector.fired >= 1) == (via == "forward"), fx
        assert (dispatch.STATS.fallbacks[("_ReduceProbe", "forward", "capture_failed")] > latched) == (via == "forward")
        assert runner.replays == 0  # the latch absorbed the fault: no replay
        _assert_identical(faulted, clean)


def test_donation_hazard_resets_with_jax_s_warning_and_replays(graph_tier):
    """The step writes its static buffers, then dies in flight: the metric resets to its defaults with JAX's
    "failed mid-flight" text, the runner replays from the last snapshot, and every reduction ends bit-identical
    with the unfaulted run; at steady state (step 3) the injector fires exactly once."""
    for fx in FXES:
        batches = _batches()
        runner = chaos.ChaosRunner(lambda: _ReduceProbe(fx), seed=SEED)
        injector = chaos.DonationHazard()
        faulted = runner.run(batches, injector=injector, fault_steps=[runner.pick_fault_step(len(batches))])
        clean = chaos.ChaosRunner(lambda: _ReduceProbe(fx), seed=SEED).run(batches)
        assert injector.fired >= 1 and runner.replays >= 1, fx
        _assert_identical(faulted, clean)
    m = _ReduceProbe("sum")
    m(*batches[0])
    with pytest.warns(UserWarning, match="A donated forward dispatch of _ReduceProbe failed mid-flight; the metric"
                                         " state was reset to defaults."):
        with chaos.DonationHazard() as hazard:
            m(*batches[1])
    # the defaults, then the batch applied eagerly
    assert hazard.fired == 1 and chaos._bytes(m.compute()) == chaos._bytes(torch.sum(torch.from_numpy(batches[1][0])))
    runner = chaos.ChaosRunner(lambda: _ReduceProbe("sum"), seed=SEED)
    injector = chaos.DonationHazard()
    faulted = runner.run(batches, injector=injector, fault_steps=[3])
    assert injector.fired == 1 and runner.replays >= 1
    _assert_identical(faulted, chaos.ChaosRunner(lambda: _ReduceProbe("sum"), seed=SEED).run(batches))


def test_preemption_between_update_and_compute():
    """A preempted instance restored from its blob ends bit-identical, for every reduction and for ``cat``."""
    batches = _batches()
    for fx in FXES:
        runner = chaos.ChaosRunner(lambda: _ReduceProbe(fx), seed=SEED)
        faulted = runner.run(batches, preempt_steps=[runner.pick_fault_step(len(batches))])
        _assert_identical(faulted, chaos.ChaosRunner(lambda: _ReduceProbe(fx), seed=SEED).run(batches))
    make = lambda: port.CatMetric(device="cpu")  # noqa: E731
    faulted = chaos.ChaosRunner(make, seed=SEED).run(batches, preempt_steps=[2, 4])
    _assert_identical(faulted, chaos.ChaosRunner(make, seed=SEED).run(batches))


@pytest.fixture(scope="module")
def jax_chaos():
    pytest.importorskip("jax")
    import torchmetrics_tpu.parallel.sync as jsync
    import torchmetrics_tpu.robust.chaos as jchaos

    return jchaos, jsync


def test_nan_poison_draws_jax_s_elements_and_mask_matches_the_zeroed_stream(jax_chaos):
    """One seed poisons the same elements with the same values in both packages; under ``nan_policy="mask"``
    the poisoned stream gives the zeroed stream's bits, and ``nan_poison_count`` is the poisoned count, for every
    reduction and for ``CatMetric``."""
    jchaos, _ = jax_chaos
    for seed, rate, n in ((SEED, 0.15, 7), (SEED + 1, 0.2, 5)):
        ours, theirs = chaos.NaNPoison(seed=seed, rate=rate), jchaos.NaNPoison(seed=seed, rate=rate)
        p, z = ours.poison(_batches(n))
        jp, jz = theirs.poison(_batches(n))
        assert ours.poisoned_elements == theirs.poisoned_elements >= 1
        for a, b in zip(p + z, jp + jz):
            assert np.asarray(a[0]).tobytes() == np.asarray(b[0]).tobytes()
    for fx in FXES:
        poisoner = chaos.NaNPoison(seed=SEED, rate=0.15)
        poisoned, zeroed = poisoner.poison(_batches())
        masked, reference = _ReduceProbe(fx, nan_policy="mask"), _ReduceProbe(fx)
        for p, z in zip(poisoned, zeroed):
            masked(*p)
            reference(*z)
        assert chaos._bytes(masked.compute()) == chaos._bytes(reference.compute()), fx
        assert masked.nan_poison_count == poisoner.poisoned_elements
    poisoner = chaos.NaNPoison(seed=SEED + 1, rate=0.2)
    poisoned, zeroed = poisoner.poison(_batches(5))
    masked = port.CatMetric(nan_strategy="ignore", nan_policy="mask", device="cpu")
    reference = port.CatMetric(nan_strategy="ignore", device="cpu")
    for p, z in zip(poisoned, zeroed):
        masked.update(*p)
        reference.update(*z)
    assert chaos._bytes(masked.compute()) == chaos._bytes(reference.compute())
    assert masked.nan_poison_count == poisoner.poisoned_elements


def test_nan_raise_policy_signals_at_compute():
    poisoned, _ = chaos.NaNPoison(seed=SEED, rate=0.3).poison(_batches(3))
    m = _ReduceProbe("sum", nan_policy="raise")
    for p in poisoned:
        m(*p)  # the hot path never raises
    with pytest.raises(NumericPoisonError):
        m.compute()


def test_counter_trail_and_seeded_fault_steps(graph_tier, jax_chaos):
    """A faulted run moves ``robust.injected_faults``, ``robust.recovered`` and ``robust.snapshots``; the counter
    names are JAX's; a seed picks JAX's fault steps."""
    jchaos, _ = jax_chaos
    before = chaos.counters()
    chaos.ChaosRunner(lambda: _ReduceProbe("sum"), seed=SEED).run(_batches(), injector=chaos.DonationHazard(),
                                                                  fault_steps=[2])
    after = chaos.counters()
    for key in ("robust.injected_faults", "robust.recovered", "robust.snapshots"):
        assert after[key] > before[key], key
    assert sorted(after) == sorted(jchaos.counters())
    r1, r2 = chaos.ChaosRunner(lambda: None, seed=77), jchaos.ChaosRunner(lambda: None, seed=77)
    assert [r1.pick_fault_step(9) for _ in range(6)] == [r2.pick_fault_step(9) for _ in range(6)]


@pytest.fixture(scope="module")
def jax_results(jax_chaos):
    from torchmetrics_tpu.aggregation import SumMetric as JaxSum

    jchaos, jsync = jax_chaos
    return {name: run_scenario(jchaos, jsync, name, JaxSum) for name in SCENARIOS}


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_matches_jax(jax_results, name):
    """``passed``, the grades, the death, preemption and flap steps, the journal counts, and every value the
    scenario computed equal JAX's on the same seed and factory."""
    ours, our_values = run_scenario(chaos, sync_mod, name, lambda: port.SumMetric(device="cpu"))
    theirs, their_values = jax_results[name]
    assert ours["passed"] is True and theirs["passed"] is True
    assert comparable(name, ours) == comparable(name, theirs)
    # the keyed and sketch scenarios compute nothing through the factory's own metrics
    assert len(our_values) == len(their_values) >= (0 if name in ("keyed_preemption_journal",
                                                                  "sketch_preemption_journal") else 1)
    for a, b in zip(our_values, their_values):
        assert a.shape == b.shape and a.tobytes() == b.astype(a.dtype).tobytes()
