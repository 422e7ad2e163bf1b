"""The port's segment reductions (``ops/segments.py``) and ``utils/data.py`` helpers against the JAX
package's, on the same numpy inputs.

``segment_*`` take unsorted ids; ids outside ``[0, num_segments)`` are dropped, and empty segments
hold ``jax.ops.segment_*``'s identities (0 for sum and count, -inf / the integer minimum for max,
+inf / the maximum for min), which the tests pin. Integer results and max/min agree exactly, float
sums within 1e-5 (another order of adds). The sorted-segment reduction of the retrieval engine is
held against ``segment_sum`` and is bitwise repeatable.
"""
from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchmetrics_tpu.ops import segments as jax_segments
from torchmetrics_tpu.utils import data as jax_data
from torchmetrics_tpu_torch.ops import segments
from torchmetrics_tpu_torch.utils import data


def _ids(rng, n, num_segments, out_of_range: bool):
    ids = rng.randint(0, num_segments, n)
    if out_of_range:
        ids[rng.rand(n) < 0.2] = -2
        ids[rng.rand(n) < 0.1] = num_segments + 3
    return ids


def _data(rng, n, dtype, trailing=()):
    shape = (n,) + trailing
    if np.issubdtype(dtype, np.floating):
        x = rng.randn(*shape).astype(dtype)
        x.reshape(-1)[rng.rand(x.size) < 0.05] = np.nan
        return x
    return rng.randint(-50, 50, shape).astype(dtype)


@pytest.mark.parametrize("name", ["segment_sum", "segment_mean", "segment_max", "segment_min"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("trailing", [(), (3,)], ids=["1d", "2d"])
@pytest.mark.parametrize("out_of_range", [False, True], ids=["in_range", "dropped_ids"])
def test_segment_reduction_matches_jax(name, dtype, trailing, out_of_range):
    rng = np.random.RandomState(zlib.crc32(repr((name, np.dtype(dtype).str, trailing, out_of_range)).encode()))
    n, num_segments = 200, 37  # some segments stay empty
    x, ids = _data(rng, n, dtype, trailing), _ids(rng, n, num_segments, out_of_range)
    if name == "segment_mean" and dtype == np.int32:
        x = x.astype(np.float32)
    ours = getattr(segments, name)(torch.from_numpy(x), torch.from_numpy(ids), num_segments).numpy()
    theirs = np.asarray(getattr(jax_segments, name)(jnp.asarray(x), jnp.asarray(ids), num_segments))
    assert ours.dtype == theirs.dtype
    if name in ("segment_max", "segment_min") or not np.issubdtype(dtype, np.floating):
        np.testing.assert_array_equal(ours, theirs)
    else:
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_segment_count_and_mean_pair_match_jax(dtype):
    rng = np.random.RandomState(5)
    ids = _ids(rng, 150, 20, True)
    x = rng.rand(150).astype(np.float32)
    jax_dtype = jnp.int32 if dtype == torch.int32 else jnp.float32
    np.testing.assert_array_equal(segments.segment_count(torch.from_numpy(ids), 20, dtype=dtype).numpy(),
                                  np.asarray(jax_segments.segment_count(jnp.asarray(ids), 20, dtype=jax_dtype)))
    sums, counts = segments.segment_mean_pair(torch.from_numpy(x), torch.from_numpy(ids), 20)
    want_sums, want_counts = jax_segments.segment_mean_pair(jnp.asarray(x), jnp.asarray(ids), 20)
    np.testing.assert_allclose(sums.numpy(), np.asarray(want_sums), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))


@pytest.mark.parametrize(("dtype", "lowest", "highest"), [
    (torch.float32, -np.inf, np.inf), (torch.float16, -np.inf, np.inf), (torch.int32, -2**31, 2**31 - 1),
    (torch.int64, -2**63, 2**63 - 1), (torch.uint8, 0, 255)])
def test_empty_segments_hold_jax_identities(dtype, lowest, highest):
    """Sum and count 0, max the lowest value, min the highest: not scatter_reduce's defaults."""
    x = torch.tensor([3, 5], dtype=dtype)
    ids = torch.tensor([1, 1])
    assert segments.segment_sum(x, ids, 3).tolist() == [0, 8, 0]
    assert segments.segment_count(ids, 3).tolist() == [0, 2, 0]
    assert segments.segment_max(x, ids, 3).tolist() == [lowest, 5, lowest]
    assert segments.segment_min(x, ids, 3).tolist() == [highest, 3, highest]
    assert segments.segment_mean(x.to(torch.float32), ids, 3).tolist() == [0.0, 4.0, 0.0]


def test_sorted_segment_reduce_matches_segment_sum_and_repeats_bitwise():
    rng = np.random.RandomState(9)
    gid = torch.from_numpy(np.sort(rng.randint(0, 40, 5000)))
    gid = torch.unique(gid, return_inverse=True)[1]  # dense 0..q-1, sorted
    x = torch.from_numpy(rng.rand(5000).astype(np.float32))
    offsets = segments.segment_offsets(gid, 5000)
    lengths = offsets[1:] - offsets[:-1]
    assert offsets[0] == 0 and offsets[-1] == 5000 and bool((lengths[int(gid.max()) + 1:] == 0).all())
    assert torch.equal(lengths, segments.segment_count(gid, 5000, dtype=torch.int64))
    got = segments.sorted_segment_reduce(x, offsets)
    np.testing.assert_allclose(got.numpy(), segments.segment_sum(x, gid, 5000).numpy(), rtol=1e-6, atol=1e-5)
    assert torch.equal(got, segments.sorted_segment_reduce(x, offsets))
    mins = segments.sorted_segment_reduce(x, offsets, "min", float("inf"))
    assert torch.equal(mins, segments.segment_min(x, gid, 5000))
    two_d = segments.sorted_segment_reduce(torch.stack([x, 2 * x], 1), offsets)
    np.testing.assert_allclose(two_d[:, 1].numpy(), 2 * got.numpy(), rtol=1e-6)


# ------------------------------------------------------------------------------ utils/data.py
def test_flatten_matches_jax():
    nested = [[1, 2], [], [3], [4, [5]]]
    assert data._flatten(nested) == jax_data._flatten(nested)


@pytest.mark.parametrize("num_classes", [None, 4, 7])
@pytest.mark.parametrize("shape", [(12,), (5, 3)])
def test_to_onehot_matches_jax(num_classes, shape):
    rng = np.random.RandomState(len(shape) + (num_classes or 0))
    labels = rng.randint(0, 4, shape)
    if num_classes:
        labels.reshape(-1)[:2] = [num_classes + 1, -1]  # outside [0, C): an all-zero column
    ours = data.to_onehot(torch.from_numpy(labels), num_classes)
    theirs = np.asarray(jax_data.to_onehot(jnp.asarray(labels), num_classes))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), theirs)


def test_to_categorical_matches_jax():
    probs = np.random.RandomState(2).rand(6, 4, 3).astype(np.float32)
    for dim in (1, 2):
        np.testing.assert_array_equal(data.to_categorical(torch.from_numpy(probs), dim).numpy(),
                                      np.asarray(jax_data.to_categorical(jnp.asarray(probs), dim)))


@pytest.mark.parametrize("minlength", [None, 3, 12])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint8])
def test_bincount_matches_jax(minlength, dtype):
    x = np.random.RandomState(4).randint(0, 9, 64).astype(dtype)
    ours = data._bincount(torch.from_numpy(x), minlength)
    theirs = np.asarray(jax_data._bincount(jnp.asarray(x), minlength))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), theirs)
    assert data._bincount(torch.zeros(0, dtype=torch.int64)).tolist() == [0]


def test_bincount_goes_through_k1_wrapper(monkeypatch):
    from torchmetrics_tpu_torch.ops import bincount as k1

    calls = []
    real = k1.bincount
    monkeypatch.setattr(k1, "bincount", lambda x, length, dtype=torch.int32: calls.append(length) or real(x, length, dtype))
    data._bincount(torch.tensor([0, 2, 2]))
    assert calls == [3]


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.bool_])
def test_cumsum_matches_jax(dtype):
    x = np.random.RandomState(6).randint(0, 3, (4, 5)).astype(dtype)
    for axis in (0, 1):
        np.testing.assert_array_equal(data._cumsum(torch.from_numpy(x), axis).numpy(),
                                      np.asarray(jax_data._cumsum(jnp.asarray(x), axis)))


def test_flexible_bincount_matches_jax():
    x = np.array([7, 3, 7, -2, 3, 7, 100])
    np.testing.assert_array_equal(data._flexible_bincount(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_data._flexible_bincount(jnp.asarray(x))))
