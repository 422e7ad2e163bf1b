"""Group fairness of the PyTorch port (functional and module) against the JAX package on the same
seeded numpy inputs.

The port counts the per-group tp/fp/tn/fn with one K1 bincount over ``4*group + 2*target + pred``
where the JAX package takes four weighted bincounts: the float32 ``(num_groups, 4)`` states must be
equal exactly, and the rates and ratios within rtol=1e-6. Pinned here: the result keys of tied
rates (the first group, as ``jnp.argmin``/``argmax`` pick it), the fused index's drop of ignored
entries, and, on the card, one K1 launch and no K2 launch per update.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.functional as tf
from torchmetrics_tpu_torch.functional.classification.group_fairness import _binary_groups_stat_scores_update

RTOL, ATOL = 1e-6, 1e-7
NUM_GROUPS = 4
TASKS = ("demographic_parity", "equal_opportunity", "all")


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu.functional as jf

    return SimpleNamespace(functional=jf, classification=jc)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _inputs(kind: str, ignore_index, seed: int, n: int = 200, num_groups: int = NUM_GROUPS):
    rng = np.random.RandomState(seed)
    preds = rng.rand(n).astype(np.float32) if kind == "probs" else (
        (rng.randn(n) * 3).astype(np.float32) if kind == "logits" else rng.randint(0, 2, n))
    target = rng.randint(0, 2, n)
    groups = rng.randint(0, num_groups, n)
    groups[:num_groups] = np.arange(num_groups)  # every group present
    if ignore_index is not None:
        target[rng.rand(n) < 0.15] = ignore_index
    return preds, target, groups


def _same_dict(ours, theirs) -> None:
    assert list(ours) == list(theirs)
    for key in theirs:
        assert ours[key].dtype == torch.float32
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(theirs[key]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["probs", "logits", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_functional_matches_jax(jax, kind, ignore_index, threshold):
    preds, target, groups = _inputs(kind, ignore_index, seed=len(kind) + (ignore_index or 0) + int(threshold * 10))
    kw = dict(threshold=threshold, ignore_index=ignore_index)
    _same_dict(tf.binary_groups_stat_rates(*_t(preds, target, groups), NUM_GROUPS, **kw),
               jax.functional.binary_groups_stat_rates(preds, target, groups, NUM_GROUPS, **kw))
    for task in TASKS:
        _same_dict(tf.binary_fairness(*_t(preds, target, groups), task=task, **kw),
                   jax.functional.binary_fairness(preds, target, groups, task=task, **kw))
    _same_dict(tf.demographic_parity(*_t(preds, groups), **kw), jax.functional.demographic_parity(preds, groups, **kw))
    _same_dict(tf.equal_opportunity(*_t(preds, target, groups), **kw),
               jax.functional.equal_opportunity(preds, target, groups, **kw))


@pytest.mark.parametrize("ignore_index", [None, -1, 0])
def test_state_equals_jax_exactly(jax, ignore_index):
    """The fused index: ignored entries get an index out of range and count nowhere."""
    from torchmetrics_tpu.functional.classification.group_fairness import (
        _binary_groups_stat_scores_update as jax_update,
    )

    preds, target, groups = _inputs("probs", ignore_index, seed=5, n=500, num_groups=6)
    ours = _binary_groups_stat_scores_update(*_t(preds, target, groups), 6, 0.5, ignore_index)
    theirs = np.asarray(jax_update(preds, target, groups, 6, 0.5, ignore_index))
    assert ours.dtype == torch.float32 and ours.shape == (6, 4)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    kept = target != ignore_index if ignore_index is not None else np.ones(target.shape, bool)
    assert ours.sum() == kept.sum()


def test_ties_take_the_first_group_as_jax_does(jax):
    """Groups 1 and 3 share the lowest positive rate and groups 0 and 2 the highest: the keys name
    group 1 and group 0, the first index of each, as ``jnp.argmin`` and ``jnp.argmax`` give."""
    preds = np.array([1, 1, 0, 0, 1, 1, 0, 0], np.int64)
    groups = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int64)
    target = np.array([1, 1, 1, 1, 1, 1, 1, 1], np.int64)
    ours = tf.binary_fairness(*_t(preds, target, groups))
    theirs = jax.functional.binary_fairness(preds, target, groups)
    assert list(ours) == list(theirs) == ["DP_1_0", "EO_1_0"]
    _same_dict(ours, theirs)
    metric = tc.BinaryFairness(4, device="cpu")
    metric.update(*_t(preds, target, groups))
    assert list(metric.compute()) == ["DP_1_0", "EO_1_0"]
    equal = tf.demographic_parity(*_t(np.ones(8, np.int64), groups))
    assert list(equal) == list(jax.functional.demographic_parity(np.ones(8, np.int64), groups)) == ["DP_0_0"]


def test_single_group_matches_jax(jax):
    preds, target, _ = _inputs("probs", None, seed=6, n=30)
    groups = np.zeros(30, np.int64)
    _same_dict(tf.binary_fairness(*_t(preds, target, groups)), jax.functional.binary_fairness(preds, target, groups))


@pytest.mark.parametrize("name,kwargs", [
    ("BinaryGroupStatRates", {}),
    ("BinaryGroupStatRates", {"ignore_index": -1, "threshold": 0.3}),
    ("BinaryFairness", {"task": "all"}),
    ("BinaryFairness", {"task": "demographic_parity", "ignore_index": -1}),
    ("BinaryFairness", {"task": "equal_opportunity"}),
])
def test_class_forward_update_compute_reset_match_jax(jax, name, kwargs):
    ours = getattr(tc, name)(NUM_GROUPS, device="cpu", **kwargs)
    theirs = getattr(jax.classification, name)(NUM_GROUPS, **kwargs)
    batches = [_inputs("logits", kwargs.get("ignore_index"), seed=10 + i) for i in range(3)]
    for batch in batches[:2]:
        _same_dict(ours(*_t(*batch)), theirs(*batch))
    ours.update(*_t(*batches[2]))
    theirs.update(*batches[2])
    _same_dict(ours.compute(), theirs.compute())
    np.testing.assert_array_equal(ours.metric_state["stats"].numpy(), np.asarray(theirs.metric_state["stats"]))
    ours.reset()
    assert not ours.metric_state["stats"].any()


def test_argument_errors_match_jax(jax):
    with pytest.raises(ValueError, match="larger than 1"):
        tc.BinaryGroupStatRates(1, device="cpu")
    with pytest.raises(ValueError, match="``demographic_parity``"):
        tc.BinaryFairness(2, task="parity", device="cpu")
    preds, target, groups = _inputs("probs", None, seed=7, n=20)
    for bad, match in ((groups + NUM_GROUPS, "in the range"), (groups.astype(np.float32), "to be int")):
        with pytest.raises(ValueError, match=match):
            jax.functional.binary_groups_stat_rates(preds, target, bad, NUM_GROUPS)
        with pytest.raises(ValueError, match=match):
            tf.binary_groups_stat_rates(*_t(preds, target, bad), NUM_GROUPS)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fairness counts launch K1 there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_one_k1_launch_and_no_k2_per_update_on_the_card(cuda_device):
    from torchmetrics_tpu_torch.ops import bincount as k1
    from torchmetrics_tpu_torch.ops import hist_pair as k2

    on_card, on_cpu = tc.BinaryFairness(8, device=cuda_device), tc.BinaryFairness(8, device="cpu")
    k1.BINCOUNT.launches, k2.HIST_PAIR.launches = 0, 0
    for step in range(5):
        batch = _t(*_inputs("probs", None, seed=20 + step, n=10_000, num_groups=8))
        on_card.update(*batch)
        on_cpu.update(*batch)
        assert k1.BINCOUNT.launches == step + 1
    assert k2.HIST_PAIR.launches == 0
    assert torch.equal(on_card.metric_state["stats"].cpu(), on_cpu.metric_state["stats"])
    assert list(on_card.compute()) == list(on_cpu.compute())
