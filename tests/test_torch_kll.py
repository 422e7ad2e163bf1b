"""The KLL sketch of the port (``sketch/kll.py``) against the JAX package's.

The same numpy inputs, made from a seed, go through ``torchmetrics_tpu.sketch.kll`` and
``torchmetrics_tpu_torch.sketch.kll``: the state equal bit for bit after every update and merge, at odd sizes, at
fewer samples than ``capacity``, at enough to fill ten levels of ``capacity=16``, and with NaN and infinities;
quantiles, CDF and KS distance equal, PSI within 1e-6. Moved from ``tests/test_torch_sketch_kinds.py`` (one file
per module).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch.sketch import kll as pk


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


# ------------------------------------------------------------------ KLL
def _kll_pair(jax, capacity, levels, sizes, seed, kind="normal"):
    """Both packages' states after each batch of ``sizes``, checked bit for bit after every update."""
    rng = np.random.RandomState(seed)
    update = jax.jit(jax.kll.kll_update)
    sj, sp = jax.kll.kll_init(capacity, levels), pk.kll_init(capacity, levels)
    stream = []
    for n in sizes:
        v = rng.normal(0, 3, n).astype(np.float32) if kind == "normal" else rng.randint(0, 17, n).astype(np.float32)
        if kind == "nan" and n > 3:
            v = rng.normal(0, 3, n).astype(np.float32)
            v[[0, n // 2]] = np.nan
            v[1], v[2] = np.inf, -np.inf
        stream.append(v)
        sj, sp = update(sj, jax.jnp.asarray(v)), pk.kll_update(sp, torch.from_numpy(v))
        assert _bits(sp) == _bits(sj), (capacity, levels, n)
    return sj, sp, np.concatenate(stream)


@pytest.mark.parametrize("capacity, levels, sizes, kind", [
    (16, 10, (1, 3, 17, 31, 255, 1023), "normal"),  # odd sizes
    (128, 24, (50, 77), "normal"),  # fewer samples than capacity
    (16, 10, (4096, 4095, 1), "normal"),  # 8192 = 16·2^9 samples: all ten levels in use, none lost
    (16, 10, (999, 999), "dupes"),
    (32, 10, (7, 400, 9000), "nan"),  # NaN and +-inf among the values
    (16, 6, (700, 700), "normal"),  # beyond capacity·2^(levels-1): the top level's carry is dropped in both
])
def test_kll_state_bit_equal_to_jax_s(jax, capacity, levels, sizes, kind):
    sj, sp, stream = _kll_pair(jax, capacity, levels, sizes, seed=capacity + levels, kind=kind)
    assert float(pk.kll_count(sp)) == float(jax.kll.kll_count(sj))
    if len(stream) <= capacity * 2 ** (levels - 1):
        assert float(pk.kll_count(sp)) == len(stream)  # weight is exact below the top level's overflow
    else:
        assert float(pk.kll_count(sp)) < len(stream)
    if len(stream) == 8192:
        assert bool((sp[:, capacity] > 0).all())  # every level holds items
    if kind == "nan":  # NaN sorts after +inf and the zeros keep their order, as in JAX: the fragments agree
        batch = np.concatenate([stream[-50:], np.array([0.0, -0.0, np.nan, np.inf, -0.0], np.float32)])
        ours, theirs = pk._bulk_fragments(torch.from_numpy(batch), 16), jax.kll._bulk_fragments(jax.jnp.asarray(batch), 16)
        assert [lvl for lvl, _ in ours] == [lvl for lvl, _ in theirs]
        assert all(_bits(a) == _bits(b) for (_, a), (_, b) in zip(ours, theirs))
        tail = torch.sort(torch.from_numpy(batch)).values[-2:].numpy()
        assert tail[0] == np.inf and np.isnan(tail[1])


def test_kll_merge_commutes_and_the_stacked_fold_is_the_pairwise_one(jax):
    parts = [_kll_pair(jax, 16, 10, (n, 3 * n + 1), seed=n)[:2] for n in (700, 2000, 31)]
    (aj, ap), (bj, bp), (cj, cp) = parts
    ab = pk.kll_merge(ap, bp)
    assert _bits(ab) == _bits(jax.kll.kll_merge(aj, bj)) == _bits(pk.kll_merge(bp, ap))
    stacked = pk.kll_merge_stacked(torch.stack([ap, bp, cp]))
    assert _bits(stacked) == _bits(pk.kll_merge(ab, cp))
    assert _bits(stacked) == _bits(jax.kll.kll_merge_stacked(jax.jnp.stack([aj, bj, cj])))
    assert float(pk.kll_count(stacked)) == float(pk.kll_count(ap) + pk.kll_count(bp) + pk.kll_count(cp))
    assert _bits(pk.kll_merge(ap, pk.kll_init(16, 10))) == _bits(ap)
    with pytest.raises(ValueError, match="cannot merge"):
        pk.kll_merge(pk.kll_init(16, 8), pk.kll_init(32, 8))
    assert pk.kll_merge_stacked.traceable


def test_kll_queries_equal_jax_s(jax):
    sj, sp, stream = _kll_pair(jax, 128, 24, (5000, 5000, 333), seed=12)
    s2j, s2p, _ = _kll_pair(jax, 128, 24, (4000,), seed=13)
    qs = np.array([0.0, 0.02, 0.1, 0.5, 0.9, 0.99, 1.0], np.float32)
    assert _bits(pk.kll_quantiles(sp, torch.from_numpy(qs))) == _bits(jax.kll.kll_quantiles(sj, jax.jnp.asarray(qs)))
    xs = np.linspace(-9, 9, 37).astype(np.float32)
    assert _bits(pk.kll_cdf(sp, torch.from_numpy(xs))) == _bits(jax.kll.kll_cdf(sj, jax.jnp.asarray(xs)))
    assert float(pk.kll_ks_distance(sp, s2p)) == float(jax.kll.kll_ks_distance(sj, s2j))
    for bins in (4, 10, 37):
        np.testing.assert_allclose(float(pk.kll_psi(sp, s2p, bins)), float(jax.kll.kll_psi(sj, s2j, bins)), rtol=1e-6)
    for a, b in zip(pk.kll_weighted_points(sp), jax.kll.kll_weighted_points(sj)):
        assert _bits(a) == _bits(b)
    data = np.sort(stream)
    for q in np.linspace(0.02, 0.98, 17):  # the documented bound
        est = float(pk.kll_quantiles(sp, torch.tensor([q]))[0])
        lo, hi = np.searchsorted(data, est, "left") / data.size, np.searchsorted(data, est, "right") / data.size
        assert lo - pk.DEFAULT_RANK_ERROR <= q <= hi + pk.DEFAULT_RANK_ERROR
    empty = pk.kll_init()
    assert torch.isnan(pk.kll_quantiles(empty, torch.tensor([0.5]))).all()
    assert torch.isnan(pk.kll_ks_distance(empty, sp))


def test_kll_init_checks_and_sizes_as_jax(jax):
    for kwargs in ({"capacity": 7}, {"capacity": 6}, {"capacity": 9}, {"levels": 1}):
        with pytest.raises(ValueError, match="kll"):
            jax.kll.kll_init(**kwargs)
        with pytest.raises(ValueError, match="kll"):
            pk.kll_init(**kwargs)
    assert _bits(pk.kll_init(16, 5)) == _bits(jax.kll.kll_init(16, 5))
    assert pk.kll_state_bytes() == jax.kll.kll_state_bytes() < 16_384


def test_kll_update_under_vmap_equals_each_element_alone():
    vals = torch.from_numpy(np.random.RandomState(15).uniform(size=(4, 300)).astype(np.float32))
    stacked = torch.func.vmap(pk.kll_update)(torch.stack([pk.kll_init()] * 4), vals)
    for k in range(4):
        assert torch.equal(stacked[k], pk.kll_update(pk.kll_init(), vals[k]))
