"""Kernel K1 of the PyTorch port (``ops/bincount.py``) and ``ops/histogram.py`` against the JAX package.

On the CPU the port's entries run their plain versions; the JAX side runs ``bincount_pallas`` in
interpret mode, as ``tests/unittests/bases/test_pallas_ops.py`` does, and its own
``confusion_matrix_update``. Counts must be equal exactly. The JAX package is imported inside a
fixture, so that the card test at the end also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_bincount.py -m cuda
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch.ops import bincount as k1
from torchmetrics_tpu_torch.ops.histogram import bincount, confusion_matrix_update


@pytest.fixture(scope="module")
def jax_hist():
    jnp = pytest.importorskip("jax.numpy")
    from torchmetrics_tpu.ops.histogram import confusion_matrix_update as jax_confusion
    from torchmetrics_tpu.ops.pallas_hist import bincount_pallas

    return jnp, bincount_pallas, jax_confusion


def _numpy_bincount(x: np.ndarray, length: int) -> np.ndarray:
    kept = x[(x >= 0) & (x < length)]
    return np.bincount(kept, minlength=length)[:length]


# the (n, length) cases of test_pallas_ops.py:15, plus an empty input
@pytest.mark.parametrize(
    "n,length", [(0, 5), (5, 3), (1000, 5), (4097, 129), (10_000, 257), (999, 1000), (20_000, 2500)]
)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_bincount_matches_pallas(jax_hist, n, length, dtype):
    jnp, bincount_pallas, _ = jax_hist
    rng = np.random.RandomState(n + length)
    x = rng.randint(-4, length + 5, n).astype(np.int32)  # negatives and values past the end are dropped
    ours = bincount(torch.from_numpy(x).to(dtype), length)
    theirs = np.asarray(bincount_pallas(jnp.asarray(x), length))
    assert ours.dtype == torch.int32 and ours.shape == (length,)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(ours.numpy(), _numpy_bincount(x, length))


def test_bincount_int64_past_int32_is_dropped():
    # JAX without x64 narrows int64 input to int32 in jnp.asarray before bincount_pallas sees it,
    # so these values are held against numpy: the port must drop them, never wrap them into a bin
    rng = np.random.RandomState(5)
    x = rng.randint(0, 25, 5000).astype(np.int64)
    x[::3] += 2**31
    x[1::7] = 2**32 + 3  # wraps to 3 if narrowed first
    x[2::11] = -(2**40)
    ours = bincount(torch.from_numpy(x), 25)
    np.testing.assert_array_equal(ours.numpy(), _numpy_bincount(x, 25))


@pytest.mark.parametrize("num_classes", [2, 5, 37, 1100])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_confusion_matrix_update_matches_jax(jax_hist, num_classes, masked, dtype):
    jnp, _, jax_confusion = jax_hist
    rng = np.random.RandomState(num_classes)
    n = 3000
    preds = rng.randint(-1, num_classes + 1, n).astype(np.int32)  # a few outside [0, C)
    target = rng.randint(-1, num_classes + 1, n).astype(np.int32)
    weights = (rng.rand(n) < 0.8).astype(np.float32) if masked else None
    ours = confusion_matrix_update(
        torch.from_numpy(preds).to(dtype), torch.from_numpy(target).to(dtype), num_classes,
        weights=None if weights is None else torch.from_numpy(weights),
    )
    theirs = np.asarray(jax_confusion(
        jnp.asarray(preds), jnp.asarray(target), num_classes, weights=None if weights is None else jnp.asarray(weights)
    ))
    assert ours.shape == (num_classes, num_classes) and ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), theirs)


@pytest.mark.parametrize("ignore_index", [0, 3, -1])
def test_confusion_ignore_index_equals_jax_mask(jax_hist, ignore_index):
    # the port drops ignore_index inside the count; the JAX package passes the mask as weights
    jnp, _, jax_confusion = jax_hist
    rng = np.random.RandomState(11)
    preds = rng.randint(0, 5, 2000)
    target = rng.randint(0, 5, 2000)
    target[rng.rand(2000) < 0.1] = ignore_index
    ours = confusion_matrix_update(torch.from_numpy(preds), torch.from_numpy(target), 5, ignore_index=ignore_index)
    keep = target != ignore_index
    theirs = np.asarray(jax_confusion(
        jnp.asarray(preds), jnp.asarray(np.where(keep, target, 0)), 5, weights=jnp.asarray(keep.astype(np.float32))
    ))
    np.testing.assert_array_equal(ours.numpy(), theirs)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("num_classes", [5, 37])
def test_int64_counts_match_jax(jax_hist, num_classes, masked):
    # the kernel writes int64 itself (stat scores count in int64); the counts are JAX's exactly
    jnp, bincount_pallas, jax_confusion = jax_hist
    rng = np.random.RandomState(num_classes + 7)
    preds = rng.randint(-1, num_classes + 1, 3000).astype(np.int32)
    target = rng.randint(-1, num_classes + 1, 3000).astype(np.int32)
    weights = (rng.rand(3000) < 0.8).astype(np.float32) if masked else None
    ours = confusion_matrix_update(
        torch.from_numpy(preds), torch.from_numpy(target), num_classes,
        weights=None if weights is None else torch.from_numpy(weights), dtype=torch.int64,
    )
    theirs = np.asarray(jax_confusion(
        jnp.asarray(preds), jnp.asarray(target), num_classes, weights=None if weights is None else jnp.asarray(weights)
    ))
    assert ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), theirs)
    x = rng.randint(-4, 130, 5000).astype(np.int32)
    counts = bincount(torch.from_numpy(x), 129, torch.int64)
    assert counts.dtype == torch.int64
    np.testing.assert_array_equal(counts.numpy(), np.asarray(bincount_pallas(jnp.asarray(x), 129)))
    plain = k1.confusion_counts_plain(torch.from_numpy(preds), torch.from_numpy(target), num_classes, dtype=torch.int64)
    assert plain.dtype == torch.int64
    np.testing.assert_array_equal(plain.numpy(), np.asarray(jax_confusion(jnp.asarray(preds), jnp.asarray(target), num_classes)))


def test_confusion_rejects_what_the_kernel_does_not_take():
    p = torch.zeros(4, dtype=torch.int64)
    # weights other than 0/1 are counted by K2 (tests/test_torch_hist_pair.py); one per sample
    with pytest.raises(ValueError, match="weights"):
        confusion_matrix_update(p, p, 3, weights=torch.tensor([0.5, 1.0, 0.0]))
    with pytest.raises(TypeError, match="int32 or int64"):
        k1.confusion_counts(p.float(), p, 3)
    with pytest.raises(ValueError, match="num_classes"):
        k1.confusion_counts(p, p, k1.MAX_CONFUSION_CLASSES + 1)
    with pytest.raises(TypeError, match="int32 or int64"):
        k1.bincount(torch.zeros(3, dtype=torch.int16), 4)
    with pytest.raises(TypeError, match="written as int32 or int64"):
        k1.bincount(p, 4, dtype=torch.float32)


def test_cpu_tensors_take_the_plain_version():
    before = k1.BINCOUNT.launches
    x = torch.tensor([0, 1, 1, 7, -2], dtype=torch.int32)
    np.testing.assert_array_equal(k1.bincount(x, 3).numpy(), [1, 2, 0])
    k1.confusion_counts(x, x, 3)
    assert k1.BINCOUNT.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is a CUDA kernel with no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda(cuda_device):
    rng = np.random.RandomState(0)
    before = k1.BINCOUNT.launches
    for length in (1, 25, 1000, 60_000, 1_000_000):  # shared and global branches
        for dtype in (torch.int32, torch.int64):
            x = rng.randint(-3, length + 3, 100_003).astype(np.int64)
            if dtype == torch.int64:
                x[::5] += 2**31
            xt = torch.from_numpy(x).to(device=cuda_device, dtype=dtype)
            assert torch.equal(k1.bincount(xt, length), k1.bincount_plain(xt, length))
    for num_classes in (5, 1000):
        p = torch.from_numpy(rng.randint(-1, num_classes + 1, 50_000)).to(cuda_device)
        t = torch.from_numpy(rng.randint(-1, num_classes + 1, 50_000).astype(np.int32)).to(cuda_device)
        mask = torch.from_numpy(rng.rand(50_000) < 0.9).to(cuda_device)
        for kw in ({}, {"ignore_index": 2}, {"mask": mask}):
            assert torch.equal(k1.confusion_counts(p, t, num_classes, **kw), k1.confusion_counts_plain(p, t, num_classes, **kw))
    empty = torch.empty(0, dtype=torch.int64, device=cuda_device)
    assert torch.equal(k1.bincount(empty, 7), torch.zeros(7, dtype=torch.int32, device=cuda_device))
    torch.cuda.synchronize()
    assert k1.BINCOUNT.launches == before + 10 + 6


def k1_card_cases(device: torch.device):
    """K1's kernel cases of ``chip_smoke.py``: ``(name, entry, args, kwargs)`` of both loaders over
    empty inputs, ragged lengths, both branches and int64 values past 2^31."""
    gen = np.random.RandomState(1)
    bins_max = k1.shared_bins_max(device)
    for dtype in (torch.int32, torch.int64):
        yield f"bincount N=0 {dtype}", "bincount", (torch.empty(0, dtype=dtype, device=device), 25), {}
        for length in (1, 25, 1000, 40_000, bins_max, bins_max + 1, 1_000_000):
            for n in (1, 4097, 1_000_003):
                x = gen.randint(-3, length + 3, n).astype(np.int64)
                if dtype == torch.int64:
                    x[::5] += 2**31  # above int32: must be dropped, never wrapped into a bin
                    x[1::7] = -(2**40)
                yield f"bincount n={n} length={length} {dtype}", "bincount", (
                    torch.from_numpy(x).to(device=device, dtype=dtype), length), {}
    big = torch.from_numpy(gen.randint(0, 25, 2**26).astype(np.int32)).to(device)
    yield "bincount N=2^26 length=25", "bincount", (big, 25), {}
    for pd, td in ((torch.int32, torch.int32), (torch.int64, torch.int32), (torch.int32, torch.int64),
                   (torch.int64, torch.int64)):
        empty_p, empty_t = torch.empty(0, dtype=pd, device=device), torch.empty(0, dtype=td, device=device)
        yield "confusion N=0", "confusion", (empty_p, empty_t, 5), {}
        for c in (2, 5, 37, 1000, 1100):
            for n in (7, 10_000, 1_000_003):
                p = gen.randint(-1, c + 1, n).astype(np.int64)
                t = gen.randint(-1, c + 1, n).astype(np.int64)
                if td == torch.int64:
                    t[::11] += 2**32
                pt = torch.from_numpy(p).to(device=device, dtype=pd)
                tt = torch.from_numpy(t).to(device=device, dtype=td)
                mask = torch.from_numpy(gen.rand(n) < 0.9).to(device)
                for kw in ({}, {"ignore_index": 0}, {"ignore_index": -1, "mask": mask}):
                    yield f"confusion C={c} n={n} {pd}/{td} {sorted(kw)}", "confusion", (pt, tt, c), kw
    big_p = torch.from_numpy(gen.randint(0, 5, 2**26).astype(np.int32)).to(device)
    yield "confusion N=2^26 C=5", "confusion", (big_p, big % 5, 5), {}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_kernel_writes_every_bin_in_dtype_on_cuda(cuda_device, dtype):
    entries = {"bincount": (k1.bincount, k1.bincount_plain), "confusion": (k1.confusion_counts, k1.confusion_counts_plain)}
    cases = 0
    for name, entry, args, kw in k1_card_cases(cuda_device):
        kernel, plain = entries[entry]
        got, want = kernel(*args, **kw, dtype=dtype), plain(*args, **kw, dtype=dtype)
        assert got.dtype == dtype and torch.equal(got, want), name
        cases += 1
    torch.cuda.synchronize()
    assert cases == 230


@pytest.mark.cuda
def test_ticket_resets_between_calls_and_streams(cuda_device):
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randint(0, 25, 1_000_003).astype(np.int32)).to(cuda_device)
    want = k1.bincount_plain(x, 25, torch.int64)
    assert torch.equal(k1.bincount(x, 25, torch.int64), want)
    assert torch.equal(k1.bincount(x, 25, torch.int64), want)  # the first call left its scratch clean
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    outs = []
    for _ in range(3):
        for stream in streams:  # calls on two streams may overlap: each stream has its own scratch
            stream.wait_stream(torch.cuda.current_stream(cuda_device))
            with torch.cuda.stream(stream):
                outs.append(k1.bincount(x, 25, torch.int64))
    torch.cuda.synchronize()
    assert all(torch.equal(out, want) for out in outs)


@pytest.mark.cuda
def test_k1_and_k3_replay_in_a_cuda_graph(cuda_device):
    from torchmetrics_tpu_torch.ops import curve_counts as k3

    rng = np.random.RandomState(6)
    preds = torch.from_numpy(rng.randint(0, 5, 100_000).astype(np.int32)).to(cuda_device)
    target = torch.from_numpy(rng.randint(0, 5, 100_000).astype(np.int32)).to(cuda_device)
    scores = torch.from_numpy(rng.rand(100_000).astype(np.float32)).to(cuda_device)
    labels = torch.from_numpy(rng.randint(0, 2, 100_000).astype(np.int32)).to(cuda_device)
    thr = torch.from_numpy(np.linspace(0, 1, 200, dtype=np.float32)).to(cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):  # warm-up: build and load the kernels outside the capture
        k1.confusion_counts(preds, target, 5, dtype=torch.int64)
        k3.binned_confmat(scores, labels, thr, "binary")
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cm = k1.confusion_counts(preds, target, 5, dtype=torch.int64)
        curve = k3.binned_confmat(scores, labels, thr, "binary")
    for step in range(3):
        preds.copy_(torch.from_numpy(rng.randint(0, 5, 100_000).astype(np.int32)))
        scores.copy_(torch.from_numpy(rng.rand(100_000).astype(np.float32)))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(cm, k1.confusion_counts_plain(preds, target, 5, dtype=torch.int64)), step
        assert torch.equal(curve, k3.binned_confmat_plain(scores, labels, thr, "binary")), step
