"""The count-min sketch of the port (``sketch/countmin.py``) against the JAX package's.

The same numpy inputs, made from a seed, go through ``torchmetrics_tpu.sketch.countmin`` and
``torchmetrics_tpu_torch.sketch.countmin``: the bucket indices of the edge ids and of random ids, the states and the
queries must be equal (float weights within 1e-6: float sums in another order). Moved from
``tests/test_torch_sketch_kinds.py`` (one file per module).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch.sketch import countmin as pcm

SPECIAL_IDS = np.array([0, 1, -1, 2**31 - 1, -(2**31), 2**31, 2**32 - 1, 2**32, -(2**63), 2**63 - 1], np.int64)


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import jax as jax_mod
    import jax.numpy as jnp

    import torchmetrics_tpu.sketch as js
    from torchmetrics_tpu.sketch import countmin, kll, state

    return SimpleNamespace(jnp=jnp, jit=jax_mod.jit, sketch=js, cm=countmin, kll=kll, state=state)


def _bits(x) -> bytes:
    return (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).tobytes()


# ------------------------------------------------------------------ count-min
@pytest.mark.parametrize("depth, width", [(4, 1024), (8, 77), (1, 2), (3, 65536)])
def test_hash_rows_equal_jax_s(jax, depth, width):
    """The bucket indices themselves, for the edge ids and random int64 and int32 ids: the low 32 bits
    of an id, as JAX's int32 wrap and uint32 cast give them, hashed by 16-bit halves."""
    rng = np.random.RandomState(depth * width)
    for ids in (SPECIAL_IDS, rng.randint(-(2**62), 2**62, 2000).astype(np.int64),
                rng.randint(-(2**31), 2**31 - 1, 2000).astype(np.int32)):
        want = np.asarray(jax.cm._hash_rows(jax.jnp.asarray(ids), depth, width))
        got = pcm._hash_rows(torch.from_numpy(ids), depth, width).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weights", ["none", "mask", "float"])
def test_update_and_query_equal_jax_s(jax, weights):
    rng = np.random.RandomState(3)
    state_j, state_p = jax.cm.cm_init(), pcm.cm_init()
    for n in (1, 777, 4096):
        ids = (rng.zipf(1.3, n) % 5000).astype(np.int32)
        w = {"none": None, "mask": rng.rand(n) < 0.5, "float": rng.rand(n).astype(np.float32)}[weights]
        state_j = jax.cm.cm_update(state_j, jax.jnp.asarray(ids), None if w is None else jax.jnp.asarray(w.astype(np.float32)))
        state_p = pcm.cm_update(state_p, torch.from_numpy(ids), None if w is None else torch.from_numpy(w))
        assert state_p.dtype == torch.float32 and state_p.shape == (4, 1024)
        if weights == "float":
            np.testing.assert_allclose(state_p.numpy(), np.asarray(state_j), rtol=1e-6, atol=1e-6)
        else:
            assert _bits(state_p) == _bits(state_j)
    probe = np.unique(ids)[:300]
    want = np.asarray(jax.cm.cm_query(state_j, jax.jnp.asarray(probe)))
    got = pcm.cm_query(state_p, torch.from_numpy(probe)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_count_min_is_one_sided_and_merges_by_sum():
    rng = np.random.RandomState(0)
    ids = (rng.zipf(1.5, 20_000) % 100_000).astype(np.int64)
    state = pcm.cm_init()
    for i in range(0, len(ids), 4096):
        state = pcm.cm_update(state, torch.from_numpy(ids[i:i + 4096]))
    uniq, true = np.unique(ids, return_counts=True)
    est = pcm.cm_query(state, torch.from_numpy(uniq)).numpy()
    assert (est >= true).all()
    assert np.mean(est - true <= pcm.cm_error_bound() * len(ids)) >= 1 - np.exp(-4)
    a = pcm.cm_update(pcm.cm_init(), torch.from_numpy(ids[:9000]))
    b = pcm.cm_update(pcm.cm_init(), torch.from_numpy(ids[9000:]))
    whole = pcm.cm_update(pcm.cm_init(), torch.from_numpy(ids))
    assert torch.equal(a + b, whole)
    assert torch.equal(pcm.cm_query(pcm.cm_init(), torch.zeros(0, dtype=torch.int64)), torch.zeros(0))


def test_count_min_checks_and_sizes_as_jax(jax):
    for kwargs in ({"depth": 0}, {"depth": 9}, {"width": 1}):
        with pytest.raises(ValueError, match="countmin"):
            jax.cm.cm_init(**kwargs)
        with pytest.raises(ValueError, match="countmin"):
            pcm.cm_init(**kwargs)
    assert pcm.cm_error_bound(512) == jax.cm.cm_error_bound(512)
    assert pcm.cm_state_bytes(3, 100) == jax.cm.cm_state_bytes(3, 100)
