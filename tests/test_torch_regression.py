"""The functional regression entries of the PyTorch port against the JAX package, on the same seeded
numpy inputs.

Every entry over its options (``num_outputs``, ``multioutput``, ``adjusted``, ``squared``,
``variant``, ``t_test``, ``alternative``, ``reduction``, ``log_prob``, Tweedie ``power`` in
{-1, 0, 1, 1.5, 2, 3}, Minkowski ``p`` in {1, 2, 3}) within rtol 1e-5 / atol 1e-6 of JAX; the edge
inputs (NaN and +-inf in Kendall, tied values, a zero in KL's ``q``, R² with one sample and with
``adjusted`` at and beyond ``n - 1``, Tweedie's domain); float64, float16 and integer inputs;
Kendall's pair counts exactly against a numpy double loop, over one block and over many; and
Pearson's ``_final_aggregation`` of 2-4 stacked replica states.
"""
from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.functional as tf
from torchmetrics_tpu_torch.functional.regression import kendall as port_kendall
from torchmetrics_tpu_torch.functional.regression.pearson import _final_aggregation, _pearson_corrcoef_update

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu.functional as jf
    from torchmetrics_tpu.functional.regression import pearson as jax_pearson

    return SimpleNamespace(functional=jf, pearson=jax_pearson)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(ours, theirs) -> None:
    ours = ours if isinstance(ours, tuple) else (ours,)
    theirs = theirs if isinstance(theirs, tuple) else (theirs,)
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        assert o.dtype == torch.float32
        assert tuple(o.shape) == np.asarray(t).shape
        np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=RTOL, atol=ATOL, equal_nan=True)


def _pair(seed: int, shape=(300,), kind: str = "real"):
    """(preds, target) float32: correlated reals, strictly positive values, tied values, or
    probability rows."""
    rng = np.random.RandomState(seed)
    preds = rng.randn(*shape).astype(np.float32)
    target = (0.7 * preds + 0.5 * rng.randn(*shape) + 0.2).astype(np.float32)
    if kind == "positive":
        return np.abs(preds) + np.float32(0.05), np.abs(target) + np.float32(0.05)
    if kind == "ties":
        return np.round(preds * 2).astype(np.float32), np.round(target * 2).astype(np.float32)
    if kind == "probs":
        e, f = np.exp(preds), np.exp(target)
        return (e / e.sum(-1, keepdims=True)).astype(np.float32), (f / f.sum(-1, keepdims=True)).astype(np.float32)
    return preds, target


#: (entry, input kind, shape, keyword arguments)
CASES = [
    ("mean_squared_error", "real", (300,), {}),
    ("mean_squared_error", "real", (300,), {"squared": False}),
    ("mean_squared_error", "real", (300, 3), {"num_outputs": 3}),
    ("mean_squared_error", "real", (300, 3), {"num_outputs": 3, "squared": False}),
    ("mean_squared_error", "real", (50, 3), {}),
    ("mean_absolute_error", "real", (300,), {}),
    ("mean_absolute_error", "real", (60, 4), {}),
    ("mean_squared_log_error", "positive", (300,), {}),
    ("mean_absolute_percentage_error", "real", (300,), {}),
    ("symmetric_mean_absolute_percentage_error", "real", (300,), {}),
    ("weighted_mean_absolute_percentage_error", "real", (300,), {}),
    ("log_cosh_error", "real", (300,), {}),
    ("log_cosh_error", "real", (300, 3), {}),
    *[("minkowski_distance", "real", (300,), {"p": p}) for p in (1, 2, 3, 2.5)],
    *[("tweedie_deviance_score", kind, (300,), {"power": power})
      for power, kind in ((-1, "positive"), (0, "real"), (1, "positive"), (1.5, "positive"), (2, "positive"),
                          (3, "positive"))],
    *[("cosine_similarity", "real", (100, 8), {"reduction": r}) for r in ("sum", "mean", "none", None)],
    *[("kl_divergence", "probs", (100, 6), {"log_prob": False, "reduction": r}) for r in ("mean", "sum", "none")],
    ("kl_divergence", "real", (100, 6), {"log_prob": True}),
    ("kl_divergence", "real", (100, 6), {"log_prob": True, "reduction": None}),
    *[("r2_score", "real", (300,), {"adjusted": a}) for a in (0, 1, 5)],
    *[("r2_score", "real", (300, 3), {"multioutput": m}) for m in ("raw_values", "uniform_average", "variance_weighted")],
    ("r2_score", "real", (300, 3), {"multioutput": "raw_values", "adjusted": 2}),
    ("relative_squared_error", "real", (300,), {}),
    ("relative_squared_error", "real", (300, 3), {"squared": False}),
    *[("explained_variance", "real", (300, 3), {"multioutput": m}) for m in ("raw_values", "uniform_average",
                                                                              "variance_weighted")],
    ("explained_variance", "real", (300,), {}),
    ("pearson_corrcoef", "real", (300,), {}),
    ("pearson_corrcoef", "real", (300, 3), {}),
    ("pearson_corrcoef", "ties", (300, 1), {}),
    ("concordance_corrcoef", "real", (300,), {}),
    ("concordance_corrcoef", "real", (300, 3), {}),
    ("spearman_corrcoef", "real", (300,), {}),
    ("spearman_corrcoef", "ties", (300,), {}),
    ("spearman_corrcoef", "ties", (300, 3), {}),
    *[("kendall_rank_corrcoef", kind, shape, {"variant": v, "t_test": True, "alternative": alt})
      for v in ("a", "b", "c") for alt in ("two-sided", "less", "greater")
      for kind, shape in (("ties", (300,)), ("real", (200, 2)))],
    *[("kendall_rank_corrcoef", "ties", (300,), {"variant": v}) for v in ("a", "b", "c")],
]


@pytest.mark.parametrize("name,kind,shape,kwargs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_functional_matches_jax(jax, name, kind, shape, kwargs):
    preds, target = _pair(len(name) + len(CASES) % 7 + len(kwargs), shape, kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the adjusted-r2 fallback warns in both packages
        ours = getattr(tf, name)(*_t(preds, target), **kwargs)
        theirs = getattr(jax.functional, name)(preds, target, **kwargs)
    _close(ours, theirs)


@pytest.mark.parametrize("dtype", [np.float64, np.float16, np.int64, np.int32])
@pytest.mark.parametrize("name", ["mean_squared_error", "mean_absolute_error", "r2_score", "explained_variance",
                                  "pearson_corrcoef", "concordance_corrcoef", "spearman_corrcoef",
                                  "kendall_rank_corrcoef", "log_cosh_error", "weighted_mean_absolute_percentage_error"])
def test_input_dtypes_match_jax(jax, name, dtype):
    """JAX narrows float64 and integer inputs to float32 (64-bit mode off) and casts float16 up; the
    port casts each in the update, so the values agree."""
    rng = np.random.RandomState(7)
    scale = 20 if np.issubdtype(dtype, np.integer) else 3
    preds = (rng.randn(200) * scale).astype(dtype)
    target = (preds.astype(np.float64) * 0.8 + rng.randn(200) * scale).astype(dtype)
    _close(getattr(tf, name)(*_t(preds, target)), getattr(jax.functional, name)(preds, target))


SPECIALS = np.array([1.0, np.nan, 2.0, np.inf, np.inf, -np.inf, 3.0, 3.0, np.nan, 0.0, -0.0, 5.0, 2.0, -1.0],
                    np.float32)


def _kendall_special(seed: int, n: int = 120):
    """Scores with NaN, +-inf, signed zeros and ties in both coordinates."""
    rng = np.random.RandomState(seed)
    x = rng.choice(SPECIALS, n).astype(np.float32)
    y = np.where(rng.rand(n) < 0.5, rng.choice(SPECIALS, n), np.round(rng.randn(n))).astype(np.float32)
    return x, y


@pytest.mark.parametrize("alternative", ["two-sided", "less", "greater"])
@pytest.mark.parametrize("variant", ["a", "b", "c"])
def test_kendall_nan_and_inf_match_jax(jax, variant, alternative):
    """``jnp.sign`` keeps NaN (``torch.sign(nan)`` is 0): a pair with a NaN difference, a NaN entry or
    ``inf - inf``, counts as neither concordant, discordant nor a tie in its own coordinate."""
    x, y = _kendall_special(len(variant) + len(alternative))
    kw = {"variant": variant, "t_test": True, "alternative": alternative}
    _close(tf.kendall_rank_corrcoef(*_t(x, y), **kw), jax.functional.kendall_rank_corrcoef(x, y, **kw))
    x2 = np.stack([x, y[::-1]], axis=1)
    y2 = np.stack([y, x[::-1]], axis=1)
    _close(tf.kendall_rank_corrcoef(*_t(x2, y2), **kw), jax.functional.kendall_rank_corrcoef(x2, y2, **kw))
    _close(tf.kendall_rank_corrcoef(*_t(x, y), variant=variant), jax.functional.kendall_rank_corrcoef(x, y, variant=variant))


def _pair_counts_loop(x: np.ndarray, y: np.ndarray):
    """JAX's definitions (``kendall.py:21-39``), one pair at a time, with ``np.sign`` (NaN stays NaN)."""
    con = dis = tx = ty = 0
    with np.errstate(invalid="ignore"):
        for i in range(len(x)):
            for j in range(i + 1, len(x)):
                sx, sy = np.sign(np.float32(x[i] - x[j])), np.sign(np.float32(y[i] - y[j]))
                con += bool(sx * sy > 0)
                dis += bool(sx * sy < 0)
                tx += bool(sx == 0 and sy != 0)
                ty += bool(sy == 0 and sx != 0)
    return [con, dis, tx, ty]


@pytest.mark.parametrize("block_bytes", [1 << 30, 32 * 90 * 7, 32 * 90])
@pytest.mark.parametrize("kind", ["special", "ties", "tiny"])
def test_kendall_pair_counts_exact(kind, block_bytes, monkeypatch):
    """The blocked pair count equals the double loop exactly, in one block (N rows) and in blocks of 7
    and of 1 row (``BLOCK_BYTES`` shrunk so that N = 90 spans many blocks)."""
    monkeypatch.setattr(port_kendall, "BLOCK_BYTES", block_bytes)
    if kind == "special":
        x, y = _kendall_special(3, 90)
    elif kind == "ties":
        x, y = _pair(4, (90,), "ties")
    else:  # differences of 1e-30 and less: their raw product underflows, the product of signs does not
        rng = np.random.RandomState(5)
        x = (rng.randint(0, 6, 90) * np.float32(1e-30)).astype(np.float32)
        y = (rng.randint(0, 6, 90) * np.float32(1e-25)).astype(np.float32)
    assert port_kendall.block_rows(90) == min(90, block_bytes // (32 * 90))
    counts = port_kendall._pair_counts(*_t(x, y))
    assert counts.dtype == torch.int64
    assert counts.tolist() == _pair_counts_loop(x, y)


def test_kendall_tiny_differences_match_jax(jax):
    rng = np.random.RandomState(6)
    x = (rng.randint(0, 6, 80) * np.float32(1e-30)).astype(np.float32)
    y = (rng.randint(0, 6, 80) * np.float32(1e-25)).astype(np.float32)
    kw = {"variant": "b", "t_test": True}
    _close(tf.kendall_rank_corrcoef(*_t(x, y), **kw), jax.functional.kendall_rank_corrcoef(x, y, **kw))


def test_kendall_pvalue_tails_match_jax(jax):
    """A strong correlation's p-value lies far in the normal tail (7e-27 and 8e-19 here), where
    ``torch.special.ndtr`` gives 0 in float32 and the port's ``erfc`` form gives JAX's value."""
    x = np.arange(120, dtype=np.float32)
    for noise in (20, 30):
        y = (x + np.random.RandomState(8).randn(120).astype(np.float32) * noise).astype(np.float32)
        for variant in "abc":
            _, p_ours = tf.kendall_rank_corrcoef(*_t(x, y), variant=variant, t_test=True, alternative="greater")
            _, p_jax = jax.functional.kendall_rank_corrcoef(x, y, variant=variant, t_test=True, alternative="greater")
            assert 0 < float(p_jax) < 1e-18
            np.testing.assert_allclose(p_ours.numpy(), np.asarray(p_jax), rtol=1e-4)


def test_spearman_ranks_ties_nan_and_signed_zero(jax):
    """Average ranks of tied values, a NaN a group of its own (sorted last), ``-0.0`` tied with ``+0.0``."""
    from torchmetrics_tpu.functional.regression.spearman import _rank_data as jax_rank
    from torchmetrics_tpu_torch.functional.regression.spearman import _rank_data

    x = np.array([3.0, -0.0, 1.0, np.nan, 0.0, 3.0, 3.0, -2.0, np.nan, 1.0], np.float32)
    ours = _rank_data(torch.from_numpy(x))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_rank(x)))
    both = _rank_data(torch.from_numpy(np.stack([x, x[::-1]], axis=1)))
    np.testing.assert_array_equal(both[:, 1].numpy(), np.asarray(jax_rank(x[::-1])))


def test_kl_zero_in_q_gives_inf_as_jax(jax):
    """JAX's ``1e-38`` guard is flushed to zero by XLA, so a zero in ``q`` where ``p > 0`` gives inf;
    the port divides by ``q`` and gives the same, where the literal in PyTorch would give 43.4."""
    p = np.array([[0.5, 0.5, 0.0], [0.2, 0.3, 0.5]], np.float32)
    q = np.array([[1.0, 0.0, 0.0], [0.1, 0.4, 0.5]], np.float32)
    for reduction in ("mean", "none"):
        ours = tf.kl_divergence(*_t(p, q), reduction=reduction)
        _close(ours, jax.functional.kl_divergence(p, q, reduction=reduction))
    assert torch.isinf(tf.kl_divergence(*_t(p[:1], q[:1])))
    # p == 0 where q == 0 contributes 0, not NaN
    _close(tf.kl_divergence(*_t(q[:1], q[:1])), jax.functional.kl_divergence(q[:1], q[:1]))


def test_r2_checks_match_jax(jax):
    from torchmetrics_tpu.utils.prints import reset_warning_cache

    one = np.array([1.5], np.float32), np.array([2.0], np.float32)
    for fn in (tf.r2_score, jax.functional.r2_score):
        with pytest.raises(ValueError, match="at least two samples"):
            fn(*(_t(*one) if fn is tf.r2_score else one))
    preds, target = _pair(9, (4,))
    for adjusted, match in ((5, "More independent regressions"), (3, "Division by zero")):
        with pytest.warns(UserWarning, match=match):
            ours = tf.r2_score(*_t(preds, target), adjusted=adjusted)
        reset_warning_cache()  # the JAX package warns once per process, and another test may have warned
        with pytest.warns(UserWarning, match=match):
            theirs = jax.functional.r2_score(preds, target, adjusted=adjusted)
        _close(ours, theirs)
    with pytest.raises(ValueError, match="`adjusted` parameter"):
        tf.r2_score(*_t(preds, target), adjusted=-1)
    with pytest.raises(ValueError, match="`multioutput` must be"):
        tf.r2_score(*_t(preds, target), multioutput="bad")


@pytest.mark.parametrize("power,preds,target", [
    (-1, [1.0, -0.5], [1.0, 2.0]),
    (1, [1.0, 2.0], [-1.0, 2.0]),
    (1.5, [0.0, 2.0], [1.0, 2.0]),
    (2, [1.0, 2.0], [0.0, 2.0]),
    (3, [-1.0, 2.0], [1.0, 2.0]),
    (0.5, [1.0, 2.0], [1.0, 2.0]),
])
def test_tweedie_domain_raises_as_jax(jax, power, preds, target):
    preds, target = np.asarray(preds, np.float32), np.asarray(target, np.float32)
    with pytest.raises(ValueError) as theirs:
        jax.functional.tweedie_deviance_score(preds, target, power=power)
    with pytest.raises(ValueError) as ours:
        tf.tweedie_deviance_score(*_t(preds, target), power=power)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("name,args", [
    ("mean_squared_error", ((3,), (4,))), ("cosine_similarity", ((3,), (3,))), ("kl_divergence", ((4, 2), (4, 3))),
    ("log_cosh_error", ((3, 2, 1), (3, 2, 1))), ("r2_score", ((2, 2, 2), (2, 2, 2))),
])
def test_shape_checks_raise_as_jax(jax, name, args):
    preds, target = (np.ones(s, np.float32) for s in args)
    with pytest.raises((RuntimeError, ValueError)) as theirs:
        getattr(jax.functional, name)(preds, target)
    with pytest.raises(type(theirs.value)):
        getattr(tf, name)(*_t(preds, target))


@pytest.mark.parametrize("replicas", [2, 3, 4])
@pytest.mark.parametrize("num_outputs", [1, 3])
def test_final_aggregation_matches_jax(jax, replicas, num_outputs):
    """Replica states stacked along a leading world axis, as sync will hand them, folded in order;
    one replica has seen no batch (n = 0)."""
    shape = (num_outputs,) if num_outputs > 1 else ()
    states = []
    for r in range(replicas):
        preds, target = _pair(20 + r, (40 + 13 * r, num_outputs) if num_outputs > 1 else (40 + 13 * r,))
        zero = torch.zeros(shape)
        state = (zero, zero, zero, zero, zero, torch.zeros(()))
        if r != 1:
            for lo in range(0, preds.shape[0], 20):
                state = _pearson_corrcoef_update(*_t(preds[lo:lo + 20], target[lo:lo + 20]), *state, num_outputs)
        states.append(state)
    stacked = [torch.stack([s[i] for s in states]) for i in range(6)]
    ours = _final_aggregation(*stacked)
    theirs = jax.pearson._final_aggregation(*(s.numpy() for s in stacked))
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=RTOL, atol=ATOL)
