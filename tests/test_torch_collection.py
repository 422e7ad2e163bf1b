"""The slice end to end: the four-metric multiclass MetricCollection of the PyTorch port against the
JAX package, on the same numpy batches.

Batch values of every ``forward`` step, ``compute()``, the compute groups and ``reset()`` must
agree; counts exactly, ratios within rtol=1e-6, atol=1e-7 (float32 division in both). State
carried from JAX mid-sweep into the port must give the JAX result of the whole sweep.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torchmetrics_tpu.classification as jc
import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu import MetricCollection as JaxCollection
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.interop import load_numpy_state

NAMES = ("MulticlassAccuracy", "MulticlassPrecision", "MulticlassRecall", "MulticlassF1Score")
CONFIGS = {
    # bench.py's headline at a small size: int labels
    "C5-labels": dict(num_classes=5, logits=False, ignore_index=None),
    # float32 logits, ignore_index=-1 on about 5% of the targets
    "C37-logits-ignore": dict(num_classes=37, logits=True, ignore_index=-1),
}


def _collections(num_classes: int, ignore_index):
    def members(pkg, **extra):
        kw = dict(num_classes=num_classes, ignore_index=ignore_index, **extra)
        return [pkg.MulticlassAccuracy(average="micro", **kw), pkg.MulticlassPrecision(**kw),
                pkg.MulticlassRecall(**kw), pkg.MulticlassF1Score(**kw)]

    return MetricCollection(members(tc, device="cpu")), JaxCollection(members(jc))


def _batches(num_classes: int, logits: bool, ignore_index, n_batches: int = 8, batch: int = 256, seed: int = 0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        target = rng.randint(0, num_classes, batch)
        if ignore_index is not None:
            target[rng.rand(batch) < 0.05] = ignore_index
        preds = rng.randn(batch, num_classes).astype(np.float32) if logits else rng.randint(0, num_classes, batch)
        out.append((preds, target))
    return out


def _assert_values(ours: dict, theirs: dict) -> None:
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(theirs[key]), rtol=1e-6, atol=1e-7, err_msg=key)


def _assert_states(port: MetricCollection, jax_mc) -> None:
    for name in NAMES:
        ours, theirs = port[name].metric_state, jax_mc[name].metric_state
        for key in ("tp", "fp", "tn", "fn"):
            np.testing.assert_array_equal(ours[key].numpy(), np.asarray(theirs[key]), err_msg=f"{name}.{key}")


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_forward_compute_reset_match_jax(config):
    cfg = CONFIGS[config]
    port, jax_mc = _collections(cfg["num_classes"], cfg["ignore_index"])
    for preds, target in _batches(**cfg):
        _assert_values(port(preds, target), jax_mc(preds, target))
    assert port.compute_groups == jax_mc.compute_groups == {0: list(NAMES)}
    _assert_states(port, jax_mc)
    _assert_values(port.compute(), jax_mc.compute())
    port.reset()
    jax_mc.reset()
    _assert_states(port, jax_mc)
    assert all(m.update_count == 0 for m in port.values())
    for preds, target in _batches(**cfg, n_batches=2, seed=1):
        _assert_values(port(preds, target), jax_mc(preds, target))
    _assert_values(port.compute(), jax_mc.compute())


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_update_then_compute_matches_jax(config):
    cfg = CONFIGS[config]
    port, jax_mc = _collections(cfg["num_classes"], cfg["ignore_index"])
    for preds, target in _batches(**cfg):
        port.update(preds, target)
        jax_mc.update(preds, target)
    assert port.compute_groups == jax_mc.compute_groups
    _assert_states(port, jax_mc)
    _assert_values(port.compute(), jax_mc.compute())


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_state_carried_from_jax_mid_sweep(config):
    cfg = CONFIGS[config]
    batches = _batches(**cfg)
    _, jax_full = _collections(cfg["num_classes"], cfg["ignore_index"])
    for preds, target in batches:
        jax_full(preds, target)
    port, jax_half = _collections(cfg["num_classes"], cfg["ignore_index"])
    for preds, target in batches[:4]:
        jax_half(preds, target)
    arrays = {name: {k: np.asarray(v) for k, v in jax_half[name].metric_state.items()} for name in NAMES}
    load_numpy_state(port, arrays)
    for name in NAMES:
        assert port[name].metric_state["tp"].dtype == torch.int64  # the port's default, not JAX's float32
    for preds, target in batches[4:]:
        port(preds, target)
    assert port.compute_groups == jax_full.compute_groups
    _assert_states(port, jax_full)
    _assert_values(port.compute(), jax_full.compute())


def test_load_numpy_state_rejects_unknown_names():
    port, _ = _collections(5, None)
    with pytest.raises(KeyError, match="No member"):
        load_numpy_state(port, {"MulticlassAUROC": {}})
    with pytest.raises(KeyError, match="no state 'support'"):
        load_numpy_state(port["MulticlassRecall"], {"support": np.zeros(5)})


def test_prefix_postfix_and_fixed_groups():
    port = MetricCollection(
        {"acc": tc.MulticlassAccuracy(num_classes=3, device="cpu"), "f1": tc.MulticlassF1Score(num_classes=3, device="cpu")},
        prefix="val_", postfix="_x", compute_groups=[["acc", "f1"]],
    )
    out = port(np.array([0, 1, 2, 2]), np.array([0, 1, 1, 2]))
    assert sorted(out) == ["val_acc_x", "val_f1_x"]
    assert port.compute_groups == {0: ["acc", "f1"]}
    assert port["f1"]._tensors["tp"] is port["acc"]._tensors["tp"]  # metric_state hands out copies


def test_groups_disabled_keeps_members_apart():
    port = MetricCollection(
        [tc.MulticlassAccuracy(num_classes=3, device="cpu"), tc.MulticlassRecall(num_classes=3, device="cpu")],
        compute_groups=False,
    )
    port.update(np.array([0, 1, 2]), np.array([0, 1, 1]))
    assert port.compute_groups == {}
    assert port["MulticlassAccuracy"]._tensors["tp"] is not port["MulticlassRecall"]._tensors["tp"]


class _JaxPair(jc.MulticlassStatScores):
    """A member whose value is a dict (``tp`` and ``fp`` sums), the case ``_flatten_dict`` serves."""

    def _compute(self, state):
        return {"tp": state["tp"].sum(), "fp": state["fp"].sum()}


class _TorchPair(tc.MulticlassStatScores):
    def _compute(self, state):
        return {"tp": state["tp"].sum(), "fp": state["fp"].sum()}


@pytest.mark.parametrize("clash", [False, True], ids=["distinct_keys", "duplicate_keys"])
def test_dict_valued_member_results_match_jax(clash):
    """One level of flattening: a member's dict keys stand alone, unless two keys of the result
    collide, when every dict key takes its member's name (JAX ``collections.py:32-49``, ``:558``)."""
    members_j = {"pair": _JaxPair(num_classes=4, average=None), "acc": jc.MulticlassAccuracy(num_classes=4)}
    members_t = {"pair": _TorchPair(num_classes=4, average=None, device="cpu"),
                 "acc": tc.MulticlassAccuracy(num_classes=4, device="cpu")}
    if clash:  # a second dict-valued member with the same keys
        members_j["other"] = _JaxPair(num_classes=4, average="micro")
        members_t["other"] = _TorchPair(num_classes=4, average="micro", device="cpu")
    ours = MetricCollection(members_t, prefix="val_", compute_groups=False)
    theirs = JaxCollection(members_j, prefix="val_", compute_groups=False)
    for preds, target in _batches(4, False, None, n_batches=3):
        # _assert_values compares the key sets (a jitted JAX compute returns its dict keys sorted)
        _assert_values(ours(preds, target), theirs(preds, target))
    result = ours.compute()
    _assert_values(result, theirs.compute())
    want = ["val_acc", "val_other_tp", "val_other_fp", "val_pair_tp", "val_pair_fp"] if clash else ["val_acc", "val_tp", "val_fp"]
    assert sorted(result) == sorted(want)
