"""Confusion matrices of the PyTorch port (functional and module) against the JAX package on the same
numpy inputs: every task, every ``normalize``, C up to 1000.

Counts must be equal exactly (the port's are int64, the JAX package's int32); normalised matrices
within rtol=1e-6, atol=1e-7 (float32 divisions in both). Also here: the ``ConfusionMatrix`` wrapper,
states carried from JAX, and on the card the count of K1 launches.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.functional as tf
from torchmetrics_tpu_torch.interop import load_numpy_state

NORMALIZE = [None, "none", "true", "pred", "all"]


@pytest.fixture(scope="module")
def jax():
    """The JAX package's side, imported here so that the card tests run without JAX:

        python -m pytest --noconftest tests/test_torch_confusion_matrix.py -m cuda
    """
    pytest.importorskip("jax")
    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu.functional as jf

    return SimpleNamespace(functional=jf, classification=jc)


def _inputs(task: str, kind: str, ignore_index, seed: int, num_classes: int = 5, n: int = 300):
    rng = np.random.RandomState(seed)
    if task == "binary":
        target = rng.randint(0, 2, (n, 2))
        preds = rng.randint(0, 2, (n, 2)) if kind == "labels" else (rng.randn(n, 2) * 2).astype(np.float32)
    elif task == "multiclass":
        target = rng.randint(0, num_classes, n)
        preds = rng.randint(0, num_classes, n) if kind == "labels" else rng.randn(n, num_classes).astype(np.float32)
    else:
        target = rng.randint(0, 2, (n, 3, 2))
        preds = rng.randint(0, 2, (n, 3, 2)) if kind == "labels" else rng.rand(n, 3, 2).astype(np.float32)
    if ignore_index is not None:
        target[rng.rand(*target.shape) < 0.1] = ignore_index
    return preds, target


def _check(ours: torch.Tensor, theirs, normalize) -> None:
    theirs = np.asarray(theirs)
    assert tuple(ours.shape) == theirs.shape
    if normalize in (None, "none"):
        assert ours.dtype == torch.int64
        np.testing.assert_array_equal(ours.numpy(), theirs)
    else:
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-6, atol=1e-7)


def _call(module, task: str, preds, target, **kwargs):
    if task == "binary":
        return module.binary_confusion_matrix(preds, target, **kwargs)
    if task == "multiclass":
        return module.multiclass_confusion_matrix(preds, target, kwargs.pop("num_classes", 5), **kwargs)
    return module.multilabel_confusion_matrix(preds, target, 3, **kwargs)


@pytest.mark.parametrize("normalize", NORMALIZE)
@pytest.mark.parametrize("ignore_index", [None, -1, 1])
@pytest.mark.parametrize("kind", ["labels", "scores"])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_functional_matches_jax(jax, task, kind, ignore_index, normalize):
    preds, target = _inputs(task, kind, ignore_index, seed=len(task) * 3 + len(kind) + (ignore_index or 0))
    kwargs = dict(normalize=normalize, ignore_index=ignore_index)
    if task != "multiclass":
        kwargs["threshold"] = 0.4
    ours = _call(tf, task, torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    _check(ours, _call(jax.functional, task, preds, target, **kwargs), normalize)


@pytest.mark.parametrize("normalize", ["true", None])
@pytest.mark.parametrize("num_classes", [37, 1000])
def test_wide_multiclass_matches_jax(jax, num_classes, normalize):
    """C = 1000: a million bins, which on the card take K1's global branch."""
    preds, target = _inputs("multiclass", "scores", -1, seed=num_classes, num_classes=num_classes, n=2000)
    kwargs = dict(num_classes=num_classes, normalize=normalize, ignore_index=-1)
    ours = _call(tf, "multiclass", torch.from_numpy(preds), torch.from_numpy(target), **dict(kwargs))
    _check(ours, _call(jax.functional, "multiclass", preds, target, **kwargs), normalize)


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
def test_task_entry_matches_jax(jax, task):
    preds, target = _inputs(task, "scores", None, seed=3)
    kwargs = dict(task=task, num_classes=5, num_labels=3, normalize="all")
    _check(tf.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(target), **kwargs),
           jax.functional.confusion_matrix(preds, target, **kwargs), "all")


@pytest.mark.parametrize("call,error", [
    (lambda f: f.binary_confusion_matrix(np.array([0.2, 0.8], np.float32), np.array([0, 2])), RuntimeError),
    (lambda f: f.binary_confusion_matrix(np.array([0, 3]), np.array([0, 1])), RuntimeError),
    (lambda f: f.binary_confusion_matrix(np.array([0.2], np.float32), np.array([0]), normalize="rows"), ValueError),
    (lambda f: f.multiclass_confusion_matrix(np.array([0, 1]), np.array([0, 7]), 3), RuntimeError),
    (lambda f: f.multiclass_confusion_matrix(np.array([0, 5]), np.array([0, 1]), 3), RuntimeError),
    (lambda f: f.multiclass_confusion_matrix(np.zeros((2, 4), np.float32), np.array([0, 1]), 3), ValueError),
    (lambda f: f.multiclass_confusion_matrix(np.array([0, 1]), np.array([0, 1]), 1), ValueError),
    (lambda f: f.multilabel_confusion_matrix(np.zeros((2, 3), np.float32), np.full((2, 3), 2), 3), RuntimeError),
    (lambda f: f.multilabel_confusion_matrix(np.zeros((2, 3), np.float32), np.zeros((2, 3), np.int64), 2), ValueError),
    (lambda f: f.confusion_matrix(np.zeros(2, np.float32), np.zeros(2, np.int64), task="multiclass"), ValueError),
])
def test_invalid_inputs_raise_like_jax(jax, call, error):
    with pytest.raises(error):
        call(jax.functional)
    with pytest.raises(error):
        call(tf)


MODULE_CASES = {
    "binary": ("BinaryConfusionMatrix", {"threshold": 0.6}, "binary"),
    "binary-ignore-true": ("BinaryConfusionMatrix", {"ignore_index": -1, "normalize": "true"}, "binary"),
    "multiclass": ("MulticlassConfusionMatrix", {"num_classes": 5}, "multiclass"),
    "multiclass-ignore-pred": ("MulticlassConfusionMatrix", {"num_classes": 5, "ignore_index": -1, "normalize": "pred"},
                               "multiclass"),
    "multilabel": ("MultilabelConfusionMatrix", {"num_labels": 3}, "multilabel"),
    "multilabel-ignore-all": ("MultilabelConfusionMatrix", {"num_labels": 3, "ignore_index": -1, "normalize": "all"},
                              "multilabel"),
}


def _pair(jax, case: str):
    name, kwargs, task = MODULE_CASES[case]
    batches = [_inputs(task, "scores", kwargs.get("ignore_index"), seed=i + len(case), n=64) for i in range(3)]
    return getattr(tc, name)(device="cpu", **kwargs), getattr(jax.classification, name)(**kwargs), batches, kwargs


@pytest.mark.parametrize("case", list(MODULE_CASES))
def test_module_forward_and_compute_match_jax(jax, case):
    port, jax_metric, batches, kwargs = _pair(jax, case)
    normalize = kwargs.get("normalize")
    for preds, target in batches:
        _check(port(preds, target), jax_metric(preds, target), normalize)
    _check(port.metric_state["confmat"], jax_metric.metric_state["confmat"], None)
    _check(port.compute(), jax_metric.compute(), normalize)
    port.reset()
    assert not port.metric_state["confmat"].any()


@pytest.mark.parametrize("case", ["binary-ignore-true", "multiclass", "multilabel-ignore-all"])
def test_state_carried_from_jax(jax, case):
    port, jax_metric, batches, kwargs = _pair(jax, case)
    for preds, target in batches[:2]:
        jax_metric.update(preds, target)
    load_numpy_state(port, {"confmat": np.asarray(jax_metric.metric_state["confmat"])})
    assert port.metric_state["confmat"].dtype == torch.int64
    port.update(*batches[2])
    jax_metric.update(*batches[2])
    _check(port.metric_state["confmat"], jax_metric.metric_state["confmat"], None)
    _check(port.compute(), jax_metric.compute(), kwargs.get("normalize"))


@pytest.mark.parametrize("kwargs,cls", [
    ({"task": "binary", "threshold": 0.3, "normalize": "true"}, "BinaryConfusionMatrix"),
    ({"task": "multiclass", "num_classes": 4, "ignore_index": -1}, "MulticlassConfusionMatrix"),
    ({"task": "multilabel", "num_labels": 3}, "MultilabelConfusionMatrix"),
])
def test_wrapper_builds_the_task_class(jax, kwargs, cls):
    ours, theirs = tc.ConfusionMatrix(device="cpu", **kwargs), jax.classification.ConfusionMatrix(**kwargs)
    assert type(ours).__name__ == type(theirs).__name__ == cls
    for attr in ("threshold", "normalize", "ignore_index", "num_classes", "num_labels"):
        if hasattr(theirs, attr):
            assert getattr(ours, attr) == getattr(theirs, attr), attr
    with pytest.raises(ValueError, match="num_labels"):
        tc.ConfusionMatrix(task="multilabel", device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the confusion matrices launch K1 there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("task,num_classes", [("binary", 2), ("multiclass", 5), ("multiclass", 1000), ("multilabel", 3)])
def test_on_cuda_one_launch_and_equal_to_cpu(cuda_device, task, num_classes):
    from torchmetrics_tpu_torch.ops import bincount as k1

    preds, target = _inputs(task, "scores", -1, seed=num_classes, num_classes=num_classes, n=5000)
    kwargs = dict(ignore_index=-1, num_classes=num_classes) if task == "multiclass" else dict(ignore_index=-1)
    k1.BINCOUNT.launches = 0
    got = _call(tf, task, torch.from_numpy(preds).to(cuda_device), torch.from_numpy(target).to(cuda_device), **dict(kwargs))
    assert k1.BINCOUNT.launches == 1
    assert torch.equal(got.cpu(), _call(tf, task, torch.from_numpy(preds), torch.from_numpy(target), **kwargs))
