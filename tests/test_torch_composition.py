"""Operator composition of the PyTorch port (``Metric``'s dunders, ``CompositionalMetric``) against the
JAX package's, on the same numpy inputs.

Every operator, forward and reflected, with a metric, a Python scalar or an array on the other
side, and the unary ones, goes through ``update``, ``compute``, ``forward`` and ``reset`` in both
packages (mirroring ``tests/unittests/bases/test_composition.py``). Then the trap the dunders set:
``==`` builds a metric, so metrics hash and compare by identity inside the port, and a collection
still groups, forwards and buffers its members. Values within 1e-5; booleans exactly.
The JAX side runs op by op (``tests/torch_jax_pool.jax_op_by_op``): each case is a configuration of its own,
which a jitted call would compile whole.
"""
from __future__ import annotations

import operator

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.metric import CompositionalMetric as JaxCompositional
from torchmetrics_tpu.metric import Metric as JaxMetric
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassF1Score
from torchmetrics_tpu_torch.metric import CompositionalMetric, Metric
from torchmetrics_tpu_torch.ops import dispatch
from torch_jax_pool import jax_op_by_op  # noqa: F401  (autouse: the JAX side op by op)
#: a case that keeps JAX's jit on (``jax_op_by_op``), so the port is held to JAX's traced branches too
JAX_JITTED_CASES = ('test_binary_operator_matches_jax[metric-add]',)


class JaxSummer(JaxMetric):
    def __init__(self, width: int = 0):
        super().__init__()
        self.add_state("x", jnp.zeros((width,) if width else ()), dist_reduce_fx="sum")

    def _update(self, state, x):
        return {"x": state["x"] + (x if state["x"].ndim else jnp.sum(x))}

    def _compute(self, state):
        return state["x"]


class TorchSummer(Metric):
    def __init__(self, width: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.add_state("x", torch.zeros((width,) if width else ()), dist_reduce_fx="sum")

    def _update(self, state, x):
        return {"x": state["x"] + (x if state["x"].dim() else torch.sum(x))}

    def _compute(self, state):
        return state["x"]


BINARY = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul, "truediv": operator.truediv,
    "floordiv": operator.floordiv, "mod": operator.mod, "pow": operator.pow, "eq": operator.eq,
    "ne": operator.ne, "lt": operator.lt, "le": operator.le, "gt": operator.gt, "ge": operator.ge,
}
BATCHES = [np.array([3.5, -1.25], np.float32), np.array([-4.0], np.float32), np.array([2.0, 0.5], np.float32)]


def assert_close(ours, theirs) -> None:
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    if theirs.dtype == bool:
        assert ours.dtype == bool and np.array_equal(ours, theirs)
    else:
        np.testing.assert_allclose(ours.astype(np.float64), theirs.astype(np.float64), rtol=1e-6, atol=1e-5)


def _drive(ours, theirs, ours_ops, theirs_ops, batches=BATCHES) -> None:
    """forward, then compute, then reset and update, through both compositions."""
    for x in batches:
        assert_close(ours(torch.from_numpy(x)), theirs(jnp.asarray(x)))
        assert_close(ours.compute(), theirs.compute())
    ours.reset()
    theirs.reset()
    for m in ours_ops + theirs_ops:
        if isinstance(m, (Metric, JaxMetric)):
            assert not m.update_called
    for x in batches[:2]:
        ours.update(torch.from_numpy(x))
        theirs.update(jnp.asarray(x))
    assert_close(ours.compute(), theirs.compute())


@pytest.mark.parametrize("name", sorted(BINARY))
@pytest.mark.parametrize("other", ["metric", "scalar", "reflected_scalar", "array"])
def test_binary_operator_matches_jax(name, other):
    op = BINARY[name]
    a_ours, a_theirs = TorchSummer(device="cpu"), JaxSummer()
    if other == "metric":
        b_ours, b_theirs = TorchSummer(device="cpu"), JaxSummer()
        ours, theirs = op(a_ours, b_ours), op(a_theirs, b_theirs)
        # the second operand sees every batch shifted, so that the two differ
        b_ours.update(torch.tensor(1.5))
        b_theirs.update(jnp.asarray(1.5))
        ops = [a_ours, b_ours], [a_theirs, b_theirs]
    elif other == "scalar":
        ours, theirs = op(a_ours, 2), op(a_theirs, 2)
        ops = [a_ours], [a_theirs]
    elif other == "reflected_scalar":
        ours, theirs = op(3.0, a_ours), op(3.0, a_theirs)
        ops = [a_ours], [a_theirs]
    else:
        ours, theirs = op(a_ours, np.array(2.5, np.float32)), op(a_theirs, np.array(2.5, np.float32))
        ops = [a_ours], [a_theirs]
    assert isinstance(ours, CompositionalMetric) and isinstance(theirs, JaxCompositional)
    _drive(ours, theirs, *ops)


@pytest.mark.parametrize("name", ["and", "or", "xor"])
@pytest.mark.parametrize("reflected", [False, True])
def test_bitwise_operators_on_comparisons_match_jax(name, reflected):
    op = {"and": operator.and_, "or": operator.or_, "xor": operator.xor}[name]
    a_ours, b_ours, a_theirs, b_theirs = TorchSummer(device="cpu"), TorchSummer(device="cpu"), JaxSummer(), JaxSummer()
    left_ours, left_theirs = a_ours > 0, a_theirs > 0
    right_ours, right_theirs = b_ours < 1, b_theirs < 1
    if reflected:  # a plain boolean on the left takes the reflected operator
        ours, theirs = op(True, left_ours), op(True, left_theirs)
    else:
        ours, theirs = op(left_ours, right_ours), op(left_theirs, right_theirs)
    _drive(ours, theirs, [a_ours, b_ours], [a_theirs, b_theirs])


@pytest.mark.parametrize("name", ["neg", "pos", "abs", "invert"])
def test_unary_operators_match_jax(name):
    a_ours, a_theirs = TorchSummer(device="cpu"), JaxSummer()
    if name == "invert":
        ours, theirs = ~(a_ours > 0), ~(a_theirs > 0)
    else:
        op = {"neg": operator.neg, "pos": operator.pos, "abs": abs}[name]
        ours, theirs = op(a_ours), op(a_theirs)
    _drive(ours, theirs, [a_ours], [a_theirs])


@pytest.mark.parametrize("name", ["getitem", "matmul", "rmatmul"])
def test_vector_operators_match_jax(name):
    a_ours, a_theirs = TorchSummer(3, device="cpu"), JaxSummer(3)
    w = np.array([0.5, -2.0, 1.0], np.float32)
    if name == "getitem":
        ours, theirs = a_ours[1], a_theirs[1]
    elif name == "matmul":
        ours, theirs = a_ours @ w, a_theirs @ jnp.asarray(w)
    else:
        ours, theirs = w.tolist() @ a_ours, w.tolist() @ a_theirs
    batches = [np.array([1.0, 2.0, 3.0], np.float32), np.array([-0.5, 4.0, 0.25], np.float32)]
    _drive(ours, theirs, [a_ours], [a_theirs], batches)


def test_composition_of_compositions_matches_jax():
    a_ours, b_ours, a_theirs, b_theirs = TorchSummer(device="cpu"), TorchSummer(device="cpu"), JaxSummer(), JaxSummer()
    ours, theirs = abs(a_ours - b_ours) * 0.5 + 1, abs(a_theirs - b_theirs) * 0.5 + 1
    b_ours.update(torch.tensor(7.0))
    b_theirs.update(jnp.asarray(7.0))
    _drive(ours, theirs, [a_ours, b_ours], [a_theirs, b_theirs])


def test_compositional_update_and_forward():
    """``test_composition.py::test_compositional_update_and_forward`` on the port."""
    a, b = TorchSummer(device="cpu"), TorchSummer(device="cpu")
    comp = a + b
    comp.update(torch.tensor(1.0))
    assert float(comp.compute()) == 2.0
    assert float(comp(torch.tensor(2.0))) == 4.0
    assert float(comp.compute()) == 6.0
    assert comp.update_count == 2 and comp.update_called
    comp.reset()
    assert float(a.compute()) == 0.0 and not comp.update_called
    assert "add" in repr(comp)


def test_keyword_arguments_reach_each_operand_filtered():
    """Each operand gets only the keyword arguments its own update takes (``_filter_kwargs``)."""
    from torchmetrics_tpu_torch.aggregation import MeanMetric

    mean, total = MeanMetric(device="cpu"), TorchSummer(device="cpu")
    comp = mean + total
    comp.update(torch.tensor([1.0, 3.0]), weight=torch.tensor([1.0, 0.0]))
    assert float(mean.compute()) == 1.0 and float(total.compute()) == 4.0
    assert float(comp.compute()) == 5.0


def test_constants_live_on_the_metric_device():
    a = TorchSummer(device="cpu")
    comp = 2.0 - a
    assert comp.device == a.device and comp.metric_a.device == a.device and comp.metric_b is a


def test_metrics_hash_and_compare_by_identity():
    """``==`` returns a truthy CompositionalMetric, so dict keys and membership must use identity."""
    a, b = TorchSummer(device="cpu"), TorchSummer(device="cpu")
    assert isinstance(a == b, CompositionalMetric) and bool(a == b)
    assert hash(a) == object.__hash__(a)
    table = {a: "a", b: "b"}
    assert table[a] == "a" and table[b] == "b"
    # the trap: an equality search finds the first metric whatever it looks for ...
    assert b in [a] and [a, b].index(b) == 0
    # ... so the port searches by identity
    assert next(i for i, m in enumerate([a, b]) if m is b) == 1 and not any(m is b for m in [a])


@pytest.mark.parametrize("tier", ["graph", "eager"])
def test_collection_groups_forwards_and_buffers_with_composing_eq(tier, monkeypatch):
    """A collection whose members' ``==`` builds metrics still forms one compute group of the
    four-way stat scores, forwards on the graph tier, and buffers: every comparison of metric
    objects inside the port is by identity."""
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    if tier == "eager":
        monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
    else:
        monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)
    rng = np.random.RandomState(0)
    preds = torch.from_numpy(rng.randint(0, 4, (6, 50)))
    target = torch.from_numpy(rng.randint(0, 4, (6, 50)))

    def make():
        return MetricCollection([MulticlassAccuracy(num_classes=4, device="cpu"),
                                 MulticlassF1Score(num_classes=4, device="cpu")])

    mc, buffered, stepped = make(), make(), make()
    dispatch.STATS.reset()
    for i in range(4):
        mc(preds[i], target[i])
    assert list(mc.compute_groups.values()) == [["MulticlassAccuracy", "MulticlassF1Score"]]
    if tier == "graph":
        assert dispatch.STATS.replays >= 3 and not dispatch.STATS.n_fallbacks
    buf = buffered.buffered(3)
    for i in range(6):
        buf.update(preds[i], target[i])
        stepped.update(preds[i], target[i])
    buf.flush()
    for key, value in stepped.compute().items():
        assert torch.equal(buffered.compute()[key], value)
    composed = mc["MulticlassAccuracy"] + mc["MulticlassF1Score"]
    expect = mc.compute()
    assert float(composed.compute()) == pytest.approx(float(expect["MulticlassAccuracy"] + expect["MulticlassF1Score"]))
