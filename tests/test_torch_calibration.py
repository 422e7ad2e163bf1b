"""Calibration error of the PyTorch port (functional and module) against the JAX package on the same
numpy inputs: binary and multiclass, ``l1``/``l2``/``max``, logits, ``ignore_index``, and
``conf == 1.0``.

The bins are held to JAX's exactly: the port's grid equals ``jnp.linspace(0, 1, n_bins + 1,
dtype=float32)`` bit for bit, and confidences placed on every boundary and on its float32
neighbours fall in the same bins, for every ``n_bins`` from 1 to 300 (with ``torch.linspace`` a
confidence of 0.8 at 15 bins would land one bin higher). Calibration errors must agree within
1e-6 absolute; the bin counts exactly; the bin sums within 1e-6 times the sum over all bins (the
port sums in float64; JAX takes differences of float32 suffix sums, which lose a few ulps of that
total in every bin).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.classification as tc
import torchmetrics_tpu_torch.functional as tf
from torchmetrics_tpu_torch.functional.classification.calibration_error import _binning_bucketize, _boundaries
from torchmetrics_tpu_torch.interop import load_numpy_state

ATOL = 1e-6


@pytest.fixture(scope="module")
def jax():
    """The JAX package's side, imported here so that the card test runs without JAX:

        python -m pytest --noconftest tests/test_torch_calibration.py -m cuda
    """
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import torchmetrics_tpu.classification as jc
    import torchmetrics_tpu.functional as jf
    from torchmetrics_tpu.functional.classification.calibration_error import _binning_bucketize as bucketize

    def grid_and_bins(conf, acc, weight, n_bins):
        return (jnp.linspace(0.0, 1.0, n_bins + 1, dtype=jnp.float32), *bucketize(conf, acc, weight, n_bins))

    # one compiled program per n_bins: the 300 grids take a minute this way, five op by op
    return SimpleNamespace(functional=jf, classification=jc, bucketize=bucketize,
                           grid_and_bins=jax.jit(grid_and_bins, static_argnums=3))


def _close(ours: torch.Tensor, theirs) -> None:
    theirs = np.asarray(theirs)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=ATOL)


def _sums_close(ours: torch.Tensor, theirs) -> None:
    """Per-bin sums, to 1e-6 of their total."""
    theirs = np.asarray(theirs)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == theirs.shape
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=ATOL * max(1.0, float(np.abs(theirs).sum())))


def _edge_values(edges: np.ndarray) -> np.ndarray:
    """Every boundary and its float32 neighbours on both sides, of the grid and of numpy's float32
    ``linspace``; a confidence is never negative, and below 0 the two packages differ only on the
    negative denormal, which XLA's CPU flushes to -0.0 and so counts in bin 0."""
    n_bins = edges.size - 1
    grids = (edges, np.linspace(0, 1, n_bins + 1).astype(np.float32))
    conf = np.concatenate([np.nextafter(g, np.float32(d)) if d else g for g in grids for d in (0, -1, 2)])
    return conf[conf >= 0].astype(np.float32)


@pytest.mark.parametrize("first", range(1, 301, 30))
def test_grid_and_bins_equal_jax_on_every_boundary(jax, first):
    for n_bins in range(first, first + 30):
        edges = _boundaries(n_bins, torch.device("cpu")).numpy()
        conf = _edge_values(edges)
        acc = (np.arange(conf.size) % 2).astype(np.float32)
        weight = np.ones_like(conf)
        jax_edges, *theirs = jax.grid_and_bins(conf, acc, weight, n_bins)
        np.testing.assert_array_equal(edges, np.asarray(jax_edges), err_msg=f"grid at n_bins={n_bins}")
        ours = _binning_bucketize(*map(torch.from_numpy, (conf, acc, weight)), n_bins)
        np.testing.assert_array_equal(ours[0].numpy(), np.asarray(theirs[0]), err_msg=f"counts at n_bins={n_bins}")
        for got, want in zip(ours[1:], theirs[1:]):
            _sums_close(got, want)


def test_point_eight_at_fifteen_bins_lands_as_in_jax(jax):
    conf, acc, weight = (torch.tensor([0.8, 1.0]), torch.ones(2), torch.ones(2))
    count = _binning_bucketize(conf, acc, weight, 15)[0]
    want = np.asarray(jax.bucketize(conf.numpy(), acc.numpy(), weight.numpy(), 15)[0])
    np.testing.assert_array_equal(count.numpy(), want)
    assert count[11] == 1 and count[15] == 1  # 0.8 in bin 11, conf == 1.0 in the extra slot
    # the grid of torch.linspace puts 0.8 one bin higher, as the reference package does
    assert int(torch.bucketize(torch.tensor(0.8), torch.linspace(0, 1, 16), right=True)) - 1 == 12


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("kind", ["probs", "logits"])
@pytest.mark.parametrize("n_bins", [1, 15, 100])
def test_binary_matches_jax(jax, norm, ignore_index, kind, n_bins):
    rng = np.random.RandomState(n_bins + len(kind))
    preds = rng.rand(300).astype(np.float32) if kind == "probs" else (rng.randn(300) * 2).astype(np.float32)
    preds[:5] = [1.0, 0.0, 0.5, 0.8, 1.0] if kind == "probs" else preds[:5]
    target = rng.randint(0, 2, 300)
    if ignore_index is not None:
        target[rng.rand(300) < 0.1] = ignore_index
    kwargs = dict(n_bins=n_bins, norm=norm, ignore_index=ignore_index)
    _close(tf.binary_calibration_error(torch.from_numpy(preds), torch.from_numpy(target), **kwargs),
           jax.functional.binary_calibration_error(preds, target, **kwargs))


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("kind", ["probs", "logits"])
@pytest.mark.parametrize("num_classes", [3, 100])
def test_multiclass_matches_jax(jax, norm, ignore_index, kind, num_classes):
    rng = np.random.RandomState(num_classes + len(kind))
    logits = (rng.randn(200, num_classes) * 2).astype(np.float32)
    preds = logits if kind == "logits" else (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    if kind == "probs":
        preds[0] = 0.0
        preds[0, 1] = 1.0  # confidence exactly 1.0
        preds[1] = 1.0 / num_classes  # every class ties: the first is the prediction
    target = rng.randint(0, num_classes, 200)
    if ignore_index is not None:
        target[rng.rand(200) < 0.1] = ignore_index
    kwargs = dict(n_bins=15, norm=norm, ignore_index=ignore_index)
    _close(tf.multiclass_calibration_error(torch.from_numpy(preds), torch.from_numpy(target), num_classes, **kwargs),
           jax.functional.multiclass_calibration_error(preds, target, num_classes, **kwargs))


@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_task_entry_matches_jax(jax, task):
    rng = np.random.RandomState(2)
    preds = rng.rand(100).astype(np.float32) if task == "binary" else rng.rand(100, 4).astype(np.float32)
    target = rng.randint(0, 2 if task == "binary" else 4, 100)
    kwargs = dict(task=task, n_bins=10, norm="l2", num_classes=4)
    _close(tf.calibration_error(torch.from_numpy(preds), torch.from_numpy(target), **kwargs),
           jax.functional.calibration_error(preds, target, **kwargs))


@pytest.mark.parametrize("call", [
    lambda f: f.binary_calibration_error(np.array([0.2, 0.8], np.float32), np.array([0, 2])),
    lambda f: f.binary_calibration_error(np.array([0, 1]), np.array([0, 1])),
    lambda f: f.binary_calibration_error(np.array([0.2, 0.8], np.float32), np.array([0, 1]), n_bins=0),
    lambda f: f.binary_calibration_error(np.array([0.2, 0.8], np.float32), np.array([0, 1]), norm="l3"),
    lambda f: f.multiclass_calibration_error(np.zeros((2, 3), np.float32), np.array([0, 3]), 3),
    lambda f: f.multiclass_calibration_error(np.zeros((2, 4), np.float32), np.array([0, 1]), 3),
    lambda f: f.calibration_error(np.zeros(2, np.float32), np.zeros(2, np.int64), task="multilabel"),
    lambda f: f.calibration_error(np.zeros((2, 3), np.float32), np.zeros(2, np.int64), task="multiclass"),
])
def test_invalid_inputs_raise_like_jax(jax, call):
    with pytest.raises((ValueError, RuntimeError)) as theirs:
        call(jax.functional)
    with pytest.raises(theirs.type):
        call(tf)


def _batches(task: str, seed: int, ignore_index=None, n_batches: int = 3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        if task == "binary":
            preds, target = rng.rand(64).astype(np.float32), rng.randint(0, 2, 64)
        else:
            preds, target = rng.randn(64, 5).astype(np.float32), rng.randint(0, 5, 64)
        if ignore_index is not None:
            target[rng.rand(64) < 0.1] = ignore_index
        out.append((preds, target))
    return out


CASES = {
    "binary-l1": ("BinaryCalibrationError", {}, "binary"),
    "binary-max-ignore": ("BinaryCalibrationError", {"norm": "max", "n_bins": 7, "ignore_index": -1}, "binary"),
    "multiclass-l2": ("MulticlassCalibrationError", {"num_classes": 5, "norm": "l2"}, "multiclass"),
    "multiclass-l1-ignore": ("MulticlassCalibrationError", {"num_classes": 5, "ignore_index": -1, "n_bins": 30},
                             "multiclass"),
}


def _pair(jax, case: str):
    name, kwargs, task = CASES[case]
    batches = _batches(task, seed=len(case), ignore_index=kwargs.get("ignore_index"))
    return getattr(tc, name)(device="cpu", **kwargs), getattr(jax.classification, name)(**kwargs), batches


def _states_close(port, jax_metric) -> None:
    ours, theirs = port.metric_state, jax_metric.metric_state
    assert sorted(ours) == sorted(theirs) == ["acc_sum", "conf_sum", "count"]
    np.testing.assert_array_equal(ours["count"].numpy(), np.asarray(theirs["count"]))
    for key in ("acc_sum", "conf_sum"):
        _sums_close(ours[key], theirs[key])


@pytest.mark.parametrize("case", list(CASES))
def test_module_forward_and_compute_match_jax(jax, case):
    port, jax_metric, batches = _pair(jax, case)
    for preds, target in batches:
        _close(port(preds, target), jax_metric(preds, target))
    _states_close(port, jax_metric)
    _close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("case", ["binary-max-ignore", "multiclass-l2"])
def test_state_carried_from_jax(jax, case):
    port, jax_metric, batches = _pair(jax, case)
    for preds, target in batches[:2]:
        jax_metric.update(preds, target)
    load_numpy_state(port, {k: np.asarray(v) for k, v in jax_metric.metric_state.items()})
    port.update(*batches[2])
    jax_metric.update(*batches[2])
    _states_close(port, jax_metric)
    _close(port.compute(), jax_metric.compute())


def test_wrapper_builds_the_task_class(jax):
    for kwargs, cls in (({"task": "binary", "n_bins": 5}, "BinaryCalibrationError"),
                        ({"task": "multiclass", "num_classes": 3, "norm": "max"}, "MulticlassCalibrationError")):
        ours, theirs = tc.CalibrationError(device="cpu", **kwargs), jax.classification.CalibrationError(**kwargs)
        assert type(ours).__name__ == type(theirs).__name__ == cls
        assert (ours.n_bins, ours.norm) == (theirs.n_bins, theirs.norm)
    with pytest.raises(ValueError, match="num_classes"):
        tc.CalibrationError(task="multiclass", device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_on_cuda_match_cpu_under_tf32_matmuls(cuda_device):
    """The per-bin product runs in float64, so TF32 float32 matmuls leave it unchanged."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        on_card = tc.MulticlassCalibrationError(num_classes=1000, ignore_index=-1, device=cuda_device)
        on_cpu = tc.MulticlassCalibrationError(num_classes=1000, ignore_index=-1, device="cpu")
        rng = np.random.RandomState(0)
        for _ in range(3):
            logits, target = rng.randn(1000, 1000).astype(np.float32), rng.randint(-1, 1000, 1000)
            torch.testing.assert_close(on_card(logits, target).cpu(), on_cpu(logits, target), rtol=0, atol=ATOL)
        assert torch.equal(on_card.metric_state["count"].cpu(), on_cpu.metric_state["count"])
        torch.testing.assert_close(on_card.compute().cpu(), on_cpu.compute(), rtol=0, atol=ATOL)
    finally:
        torch.set_float32_matmul_precision(before)
