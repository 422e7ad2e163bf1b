"""Kernel K2 of the PyTorch port (``ops/hist_pair.py``) and the weighted counts of
``ops/histogram.py`` against the JAX package.

On the CPU the port's entries run their plain versions. The JAX side runs ``hist_pair_pallas``
in interpret mode, as ``tests/unittests/sketch/test_countmin_hist.py`` does, and its own
``hist_pair``, ``bincount_weighted`` and ``confusion_matrix_update``. Sums of 0/1 and of
integer-valued weights are integers below 2^24 and must be equal exactly; sums of general
float32 weights agree within rtol 1e-6. The JAX package is imported inside a fixture, so that
the card test at the end also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_hist_pair.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch.ops import hist_pair as k2
from torchmetrics_tpu_torch.ops.histogram import bincount_weighted, confusion_matrix_update, hist_pair


@pytest.fixture(scope="module")
def jax_hist():
    jnp = pytest.importorskip("jax.numpy")
    from torchmetrics_tpu.ops import histogram as jax_histogram
    from torchmetrics_tpu.ops.pallas_hist import hist_pair_pallas

    return jnp, hist_pair_pallas, jax_histogram


def _inputs(n: int, length: int, seed: int, weights: str = "binary"):
    """Indices with some negative and some at or past ``length``; weights 0/1 or general."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(-3, length + 3, n).astype(np.int64)
    if weights == "binary":
        pos = (rng.rand(n) < 0.5).astype(np.float32)
        neg = ((1.0 - pos) * (rng.rand(n) < 0.8)).astype(np.float32)
    else:
        pos = rng.rand(n).astype(np.float32)
        neg = rng.rand(n).astype(np.float32)
    return idx, pos, neg


def _numpy_pair(idx, pos, neg, length):
    keep = (idx >= 0) & (idx < length)
    return np.stack([np.bincount(idx[keep], w[keep], minlength=length) for w in (pos, neg)])


@pytest.mark.parametrize("length", [1, 7, 257, 2048, 10_240])
@pytest.mark.parametrize("n", [0, 5, 4097])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_matches_pallas_and_hist_pair(jax_hist, length, n, dtype):
    jnp, hist_pair_pallas, jax_histogram = jax_hist
    idx, pos, neg = _inputs(n, length, seed=n + length)
    ours = hist_pair(torch.from_numpy(idx).to(dtype), torch.from_numpy(pos), torch.from_numpy(neg), length)
    assert ours.dtype == torch.float32 and ours.shape == (2, length)
    np.testing.assert_array_equal(ours.numpy(), _numpy_pair(idx, pos, neg, length))
    args = (jnp.asarray(idx.astype(np.int32)), jnp.asarray(pos), jnp.asarray(neg), length)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_histogram.hist_pair(*args)))
    if length <= 2048:  # the interpret-mode kernel compares every bin block with every sample tile
        np.testing.assert_array_equal(ours.numpy(), np.asarray(hist_pair_pallas(*args)))


def test_general_weights_match_within_rtol(jax_hist):
    jnp, hist_pair_pallas, jax_histogram = jax_hist
    idx, pos, neg = _inputs(20_000, 257, seed=4, weights="general")
    ours = hist_pair(torch.from_numpy(idx), torch.from_numpy(pos), torch.from_numpy(neg), 257).numpy()
    args = (jnp.asarray(idx.astype(np.int32)), jnp.asarray(pos), jnp.asarray(neg), 257)
    np.testing.assert_allclose(ours, np.asarray(hist_pair_pallas(*args)), rtol=1e-6)
    np.testing.assert_allclose(ours, np.asarray(jax_histogram.hist_pair(*args)), rtol=1e-6)


def test_int64_past_int32_is_dropped():
    # JAX without x64 narrows int64 to int32 before its kernel sees it, so these are held against
    # numpy: the port must drop them, never wrap them into a bin
    idx, pos, neg = _inputs(5000, 25, seed=5)
    idx[::3] += 2**31
    idx[1::7] = 2**32 + 3  # wraps to 3 if narrowed first
    idx[2::11] = -(2**40)
    ours = hist_pair(torch.from_numpy(idx), torch.from_numpy(pos), torch.from_numpy(neg), 25)
    np.testing.assert_array_equal(ours.numpy(), _numpy_pair(idx, pos, neg, 25))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("length", [7, 3000])
def test_bincount_weighted_matches_jax(jax_hist, weighted, length):
    jnp, _, jax_histogram = jax_hist
    rng = np.random.RandomState(length)
    x = rng.randint(-2, length + 2, 6000).astype(np.int32)
    weights = rng.randint(0, 4, 6000).astype(np.float32) if weighted else None  # integer sums: exact in any order
    ours = bincount_weighted(torch.from_numpy(x), length, None if weights is None else torch.from_numpy(weights))
    theirs = np.asarray(jax_histogram.bincount_weighted(
        jnp.asarray(x), length, None if weights is None else jnp.asarray(weights)
    ))
    assert ours.numpy().dtype == theirs.dtype
    np.testing.assert_array_equal(ours.numpy(), theirs)


@pytest.mark.parametrize("num_classes", [3, 37, 1100])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_weighted_confusion_matrix_update_matches_jax(jax_hist, num_classes, dtype):
    jnp, _, jax_histogram = jax_hist
    rng = np.random.RandomState(num_classes)
    n = 4000
    preds = rng.randint(-1, num_classes + 1, n).astype(np.int32)
    target = rng.randint(-1, num_classes + 1, n).astype(np.int32)
    weights = rng.randint(0, 5, n).astype(np.float32)  # integer-valued: f32 sums are exact in any order
    ours = confusion_matrix_update(torch.from_numpy(preds), torch.from_numpy(target), num_classes,
                                   weights=torch.from_numpy(weights), dtype=dtype)
    theirs = np.asarray(jax_histogram.confusion_matrix_update(
        jnp.asarray(preds), jnp.asarray(target), num_classes, weights=jnp.asarray(weights),
        dtype=jnp.int32 if dtype == torch.int32 else jnp.float32,
    ))
    assert ours.shape == (num_classes, num_classes) and ours.dtype == dtype
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_weighted_confusion_truncates_to_int32_as_jax(jax_hist):
    jnp, _, jax_histogram = jax_hist
    preds = np.array([0, 1, 1, 2, 2, 2], np.int32)
    target = np.array([0, 1, 0, 2, 2, 1], np.int32)
    weights = np.array([0.5, 1.5, 2.25, 0.75, 0.5, 3.0], np.float32)  # dyadic: exact sums
    ours = confusion_matrix_update(torch.from_numpy(preds), torch.from_numpy(target), 3, weights=torch.from_numpy(weights))
    theirs = np.asarray(jax_histogram.confusion_matrix_update(jnp.asarray(preds), jnp.asarray(target), 3, jnp.asarray(weights)))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(ours.numpy(), [[0, 2, 0], [0, 1, 3], [0, 0, 1]])  # rows are targets


def test_weighted_confusion_drops_ignore_index():
    preds = torch.tensor([0, 1, 1, 2])
    target = torch.tensor([0, 1, 2, 2])
    cm = confusion_matrix_update(preds, target, 3, weights=torch.tensor([2.0, 3.0, 4.0, 5.0]), ignore_index=2,
                                 dtype=torch.float32)
    np.testing.assert_array_equal(cm.numpy(), [[2, 0, 0], [0, 3, 0], [0, 0, 0]])


def test_rejects_what_the_kernel_does_not_take():
    idx = torch.zeros(4, dtype=torch.int64)
    w = torch.ones(4)
    with pytest.raises(TypeError, match="int32 or int64"):
        k2.hist_pair(idx.float(), w, w, 3)
    with pytest.raises(TypeError, match="float32"):
        k2.hist_pair(idx, w.double(), w, 3)
    with pytest.raises(ValueError, match="one per index"):
        k2.hist_pair(idx, w[:3], w, 3)
    with pytest.raises(ValueError, match="length"):
        k2.hist_pair(idx, w, w, 0)


def test_cpu_tensors_take_the_plain_version():
    before = k2.HIST_PAIR.launches
    out = k2.hist_pair(torch.tensor([0, 2, 2, 5], dtype=torch.int32), torch.tensor([1.0, 1.0, 0.0, 1.0]), None, 3)
    np.testing.assert_array_equal(out.numpy(), [[1, 0, 1], [0, 0, 0]])
    assert k2.HIST_PAIR.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2 is a CUDA kernel with no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda(cuda_device):
    before = k2.HIST_PAIR.launches
    launched = 0
    bins_max = k2.shared_bins_max(cuda_device)
    for length in (1, 2048, 10_240, bins_max, bins_max + 1, 2_048_000):  # shared and global branches
        for dtype in (torch.int32, torch.int64):
            for weights in ("binary", "general"):
                idx, pos, neg = _inputs(100_003, length, seed=length, weights=weights)
                if dtype == torch.int64:
                    idx[::5] += 2**31
                args = [torch.from_numpy(idx).to(device=cuda_device, dtype=dtype),
                        torch.from_numpy(pos).to(cuda_device), torch.from_numpy(neg).to(cuda_device)]
                got, want = k2.hist_pair(*args, length), k2.hist_pair_plain(*args, length)
                launched += 1
                if weights == "binary":
                    assert torch.equal(got, want)
                else:
                    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    one_stream = k2.hist_pair(args[0], args[1], None, 2_048_000)
    torch.testing.assert_close(one_stream, k2.hist_pair_plain(args[0], args[1], None, 2_048_000), rtol=1e-5, atol=1e-5)
    empty = torch.empty(0, dtype=torch.int64, device=cuda_device)
    assert torch.equal(k2.hist_pair(empty, empty.float(), empty.float(), 7), torch.zeros((2, 7), device=cuda_device))
    torch.cuda.synchronize()
    assert k2.HIST_PAIR.launches == before + launched + 1
