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


# ------------------------------------------------------------------ the dict-like surface (queue C, C1)
def _members(pkg, **extra):
    return (pkg.MulticlassAccuracy(num_classes=3, **extra), pkg.MulticlassPrecision(num_classes=3, **extra),
            pkg.MulticlassRecall(num_classes=3, average="micro", **extra))


NESTINGS = {
    "positional_extras": lambda pkg, C, **kw: C(*_members(pkg, **kw)),
    "list_plus_extras": lambda pkg, C, **kw: C(list(_members(pkg, **kw)[:2]), _members(pkg, **kw)[2], prefix="v_"),
    "nested_alone": lambda pkg, C, **kw: C(C(list(_members(pkg, **kw)), prefix="in_", postfix="_x")),
    "nested_in_list": lambda pkg, C, **kw: C([_members(pkg, **kw)[0], C(list(_members(pkg, **kw)[1:]), postfix="_q")]),
    "nested_as_dict_value": lambda pkg, C, **kw: C({"a": _members(pkg, **kw)[0],
                                                    "b": C([_members(pkg, **kw)[1]], prefix="p_")}, postfix="_o"),
}


@pytest.mark.parametrize("nesting", sorted(NESTINGS))
def test_nested_collections_and_positional_extras_match_jax(nesting):
    ours = NESTINGS[nesting](tc, MetricCollection, device="cpu")
    theirs = NESTINGS[nesting](jc, JaxCollection)
    assert list(ours.keys()) == list(theirs.keys())
    assert list(ours.keys(keep_base=True)) == list(theirs.keys(keep_base=True))
    assert list(ours) == list(theirs) and len(ours) == len(theirs)
    for key in theirs.keys(keep_base=True):
        assert key in ours and type(ours[key]).__name__ == type(theirs[key]).__name__
    assert (ours.prefix, ours.postfix) == (theirs.prefix, theirs.postfix)
    for preds, target in _batches(3, False, None, n_batches=3, batch=64):
        _assert_values(ours(preds, target), theirs(preds, target))
    assert ours.compute_groups == theirs.compute_groups
    _assert_values(ours.compute(), theirs.compute())
    assert [k for k, _ in ours.items()] == [k for k, _ in theirs.items()]
    assert [type(m).__name__ for m in ours.values(copy_state=False)] == [type(m).__name__ for m in theirs.values()]


def test_dict_with_positional_extras_raises_as_jax():
    acc = tc.MulticlassAccuracy(num_classes=3, device="cpu")
    with pytest.raises(ValueError, match="extra positional arguments"):
        MetricCollection({"a": acc}, tc.MulticlassRecall(num_classes=3, device="cpu"))
    with pytest.warns(UserWarning, match="Ignoring extra non-Metric"):
        mc = MetricCollection([acc], 5)
    assert list(mc.keys()) == ["MulticlassAccuracy"]


def test_persistent_to_set_dtype_repr_and_keyed():
    ours = MetricCollection(list(_members(tc, device="cpu")), prefix="val_")
    theirs = JaxCollection(list(_members(jc)), prefix="val_")
    for preds, target in _batches(3, False, None, n_batches=2, batch=32):
        ours.update(preds, target)
        theirs.update(preds, target)
    assert ours.state_dict() == {} and theirs.state_dict() == {}
    ours.persistent(True)
    theirs.persistent(True)
    assert sorted(ours.state_dict()) == sorted(theirs.state_dict())
    for key, value in theirs.state_dict().items():
        np.testing.assert_array_equal(np.asarray(ours.state_dict()[key]), np.asarray(value))
    assert ours.to("cpu") is ours and ours.set_dtype(torch.float64) is ours
    assert all(m.dtype == torch.float64 for m in ours.values())
    text = repr(ours)
    assert text.startswith("MetricCollection(\n  prefix=val_") and "(MulticlassRecall): MulticlassRecall" in text
    keyed = MetricCollection([tc.MulticlassAccuracy(num_classes=3, device="cpu")]).keyed(4)
    from torchmetrics_tpu_torch.keyed import KeyedMetricCollection

    assert isinstance(keyed, KeyedMetricCollection) and list(keyed.keys()) == ["MulticlassAccuracy"]
