"""``MetricCollection.sweep_fn`` of the PyTorch port against the JAX package's, run under
``jax.jit`` on the CPU, on the same stacked numpy batches from a seed.

The collections of paths A, E and F (see ``test_torch_update_batches.py``) and an aggregation
collection with compute groups off fold a stack into fresh default states. Values match JAX's
within 1e-6 (stat scores), 1e-5 (curves) and rtol 1e-5 (aggregations); the persistent state must
stay as it was; a sweep before the groups form, and a member with list states, raise as in JAX.
Each case runs on the eager tier and on the graph tier's bookkeeping (``dispatch.EMULATE_ON_CPU``),
where a second call of the same signature replays.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.aggregation as ja
import torchmetrics_tpu.classification as jc
import torchmetrics_tpu_torch.aggregation as ta
import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu import MetricCollection as JaxCollection
from torchmetrics_tpu.utils.exceptions import TorchMetricsUserError as JaxUserError
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.ops import dispatch
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

from tests.test_torch_update_batches import PATHS, assert_values, stack


@pytest.fixture(params=["eager", "graph"])
def tier(request, monkeypatch):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", request.param == "graph")
    dispatch.STATS.reset()
    return request.param


def _formed(port, theirs, kind):
    """Both collections after one forward on a batch of their own, which forms the groups."""
    preds, target = stack(kind, n_batches=1, batch=64, seed=9)
    port(torch.from_numpy(preds[0]), torch.from_numpy(target[0]))
    theirs(jnp.asarray(preds[0]), jnp.asarray(target[0]))
    return port, theirs


@pytest.mark.parametrize("path", sorted(PATHS))
def test_sweep_fn_matches_jax_and_leaves_the_state(tier, path):
    members, kind, keys, tol = PATHS[path]
    port, theirs = _formed(MetricCollection(members(tc, device="cpu")), JaxCollection(members(jc)), kind)
    before = {name: port[name].metric_state for name in port._modules}
    fn, jfn = port.sweep_fn(), jax.jit(theirs.sweep_fn())
    for seed in (0, 1):  # the second call of one signature replays its graph
        preds, target = stack(kind, seed=seed)
        assert_values(fn(torch.from_numpy(preds), torch.from_numpy(target)), jfn(jnp.asarray(preds), jnp.asarray(target)), tol)
    for name, state in before.items():
        for key in keys:
            assert torch.equal(port[name].metric_state[key], state[key])
    if tier == "graph":
        # the first forward captured and replayed each of the four members; then one sweep capture, two replays
        assert dispatch.STATS.captures == 4 + 1 and dispatch.STATS.replays == 4 + 2


def test_aggregation_sweep_without_groups_matches_jax(tier):
    rng = np.random.RandomState(5)
    values = rng.randn(7, 30).astype(np.float32)

    def members(pkg, **kw):
        return {"mean": pkg.MeanMetric(**kw), "max": pkg.MaxMetric(**kw), "sum": pkg.SumMetric(**kw)}

    port = MetricCollection(members(ta, device="cpu"), compute_groups=False)
    theirs = JaxCollection(members(ja), compute_groups=False)
    ours, want = port.sweep_fn()(torch.from_numpy(values)), jax.jit(theirs.sweep_fn())(jnp.asarray(values))
    for name in ("mean", "max", "sum"):
        np.testing.assert_allclose(ours[name].numpy(), np.asarray(want[name]), rtol=1e-5, err_msg=name)
    assert float(ours["max"]) == float(values.max())


def test_sweep_fn_raises_before_groups_form(tier):
    port, theirs = MetricCollection(PATHS["A"][0](tc, device="cpu")), JaxCollection(PATHS["A"][0](jc))
    with pytest.raises(JaxUserError, match="requires formed compute groups"):
        theirs.sweep_fn()
    with pytest.raises(TorchMetricsUserError, match="requires formed compute groups"):
        port.sweep_fn()


def test_sweep_fn_raises_for_list_states(tier):
    def members(pkg, **kw):
        return [pkg.BinaryAUROC(**kw), pkg.BinaryAveragePrecision(**kw)]  # exact mode: list states

    port, theirs = _formed(MetricCollection(members(tc, device="cpu")), JaxCollection(members(jc)), "binary")
    with pytest.raises(JaxUserError, match="not scan-fusable"):
        theirs.sweep_fn()
    with pytest.raises(TorchMetricsUserError, match="not scan-fusable"):
        port.sweep_fn()
