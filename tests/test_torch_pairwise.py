"""The port's pairwise distances (``functional/pairwise``) against the JAX package's.

The same seeded numpy rows go through both packages on the CPU: the five entries over ``y`` given
or not, ``zero_diagonal`` left to its default, forced on and off, each reduction, minkowski's
exponents (1, 2, 3, 4.5), integer inputs (the linear and manhattan matrices stay integers, exact)
and float64 rows (computed in float32, as JAX computes them with 64-bit mode off), and every
validation error. Values agree within rtol 1e-5 / atol 1e-6; cosine's atol is 1e-5 near 0, where
a float32 product of unit rows cancels. A row's euclidean distance to itself, kept with
``zero_diagonal=False``, is the square root of the Gram expansion's float32 residual in both
packages (``x² + x² - 2·x·x``, a few ulps of ``2‖x‖²``, or 0 after the clamp): it is held to the
bound ``sqrt((d + 4)·2^-24·2‖x‖²)``, and so are the reductions over rows that include it. The broadcast forms are held to the same values when their
blocks of rows are shrunk to a few rows (``distances.BLOCK_BYTES``), and the products keep full
float32 under a caller's ``torch.set_float32_matmul_precision("high")``, which they leave as it was.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.functional as pf
from torchmetrics_tpu_torch.functional.pairwise import distances
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

NAMES = ("cosine_similarity", "euclidean_distance", "linear_similarity", "manhattan_distance", "minkowski_distance")
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu.functional as jf
    from torchmetrics_tpu.utils.exceptions import TorchMetricsUserError as JaxUserError

    return SimpleNamespace(f=jf, UserError=JaxUserError)


def _rows(seed: int, n: int = 23, m: int = 17, d: int = 12, dtype=np.float32):
    rng = np.random.RandomState(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.randint(-6, 7, (n, d)).astype(dtype), rng.randint(-6, 7, (m, d)).astype(dtype)
    return (rng.randn(n, d) * 2).astype(dtype), (rng.randn(m, d) * 2 + 0.5).astype(dtype)


def _close(ours: torch.Tensor, theirs, atol: float = ATOL) -> None:
    theirs = np.asarray(theirs)
    assert tuple(ours.shape) == theirs.shape
    if np.issubdtype(theirs.dtype, np.integer):
        assert not ours.is_floating_point()
        np.testing.assert_array_equal(ours.numpy(), theirs)
    else:
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=RTOL, atol=atol)


def _call(ns, name, x, y, **kwargs):
    fn = getattr(ns, "pairwise_" + name)
    return fn(x, y, **kwargs) if y is not None else fn(x, **kwargs)


@pytest.mark.parametrize("zero_diagonal", [None, True, False])
@pytest.mark.parametrize("reduction", [None, "none", "mean", "sum"])
@pytest.mark.parametrize("with_y", [True, False])
@pytest.mark.parametrize("name", NAMES)
def test_entry_matches_jax(jax, name, with_y, reduction, zero_diagonal):
    x, y = _rows(len(name) + 3 * with_y)
    y = y if with_y else None
    kwargs = {"reduction": reduction, "zero_diagonal": zero_diagonal}
    ours = _call(pf, name, torch.from_numpy(x), None if y is None else torch.from_numpy(y), **kwargs)
    theirs = _call(jax.f, name, x, y, **kwargs)
    atol = 1e-5 if name == "cosine_similarity" else ATOL
    if name == "euclidean_distance" and y is None and zero_diagonal is False:
        atol = _self_distance_bound(x)
    _close(ours, theirs, atol=atol)


def _self_distance_bound(x: np.ndarray) -> float:
    """The float32 residual of ``x² + x² - 2·x·x`` under its square root, for the largest row."""
    return float(np.sqrt((x.shape[1] + 4) * 2.0**-24 * 2 * np.max(np.sum(x.astype(np.float64) ** 2, axis=1))))


@pytest.mark.parametrize("exponent", [1, 2, 3, 4.5])
def test_minkowski_exponents_match_jax(jax, exponent):
    x, y = _rows(5)
    for args in ((x, y), (x, None)):
        ours = pf.pairwise_minkowski_distance(*(None if a is None else torch.from_numpy(a) for a in args), exponent=exponent)
        _close(ours, jax.f.pairwise_minkowski_distance(*args, exponent=exponent))


@pytest.mark.parametrize("reduction", [None, "sum", "mean"])
@pytest.mark.parametrize("name", NAMES)
def test_integer_inputs_match_jax(jax, name, reduction):
    """Integer rows: the linear and manhattan matrices (and their sums) are integers, exactly JAX's;
    the mean of an integer matrix is float32; cosine, euclidean and minkowski compute in float32."""
    x, y = _rows(11, dtype=np.int64)
    ours = _call(pf, name, torch.from_numpy(x), torch.from_numpy(y), reduction=reduction)
    _close(ours, _call(jax.f, name, x, y, reduction=reduction))


@pytest.mark.parametrize("name", NAMES)
def test_float64_inputs_compute_in_float32(jax, name):
    x, y = _rows(13, dtype=np.float64)
    _close(_call(pf, name, torch.from_numpy(x), torch.from_numpy(y)), _call(jax.f, name, x, y),
           atol=1e-5 if name == "cosine_similarity" else ATOL)


@pytest.mark.parametrize("name", ["manhattan_distance", "minkowski_distance", "linear_similarity"])
def test_row_blocks_give_the_same_values(monkeypatch, name):
    """A block of at most 3 rows: every element is the same operations as in one broadcast, so the
    matrix is bit-equal to the one-block run (the linear form blocks its integer products only)."""
    x, y = _rows(17, dtype=np.int64 if name == "linear_similarity" else np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    whole = _call(pf, name, xt, yt)
    monkeypatch.setattr(distances, "BLOCK_BYTES", 3 * y.shape[0] * y.shape[1] * x.itemsize)
    assert distances.block_rows(y.shape[0], y.shape[1], x.itemsize) == 3
    assert torch.equal(_call(pf, name, xt, yt), whole)


def test_non_square_diagonal_and_defaults(jax):
    """``zero_diagonal=True`` against ``y`` zeroes the leading diagonal of a non-square matrix; with
    ``y`` absent the default zeroes it, with ``y`` given it does not."""
    x, y = _rows(19, n=5, m=9)
    ours = pf.pairwise_euclidean_distance(torch.from_numpy(x), torch.from_numpy(y), zero_diagonal=True)
    _close(ours, jax.f.pairwise_euclidean_distance(x, y, zero_diagonal=True))
    assert torch.all(ours.diagonal() == 0) and ours.shape == (5, 9)
    assert torch.all(pf.pairwise_linear_similarity(torch.from_numpy(x)).diagonal() == 0)
    same = pf.pairwise_linear_similarity(torch.from_numpy(x), torch.from_numpy(x))
    assert torch.all(same.diagonal() > 0)


def test_euclidean_clamps_the_gram_residual(jax):
    """Identical rows: the expansion's tiny negative residuals are clamped to 0, as in JAX, so no NaN."""
    x = (np.random.RandomState(23).randn(6, 40) * 30).astype(np.float32)
    ours = pf.pairwise_euclidean_distance(torch.from_numpy(x), torch.from_numpy(x.copy()))
    assert not torch.isnan(ours).any()
    _close(ours, jax.f.pairwise_euclidean_distance(x, x.copy()), atol=_self_distance_bound(x))


def _outcome(fn):
    try:
        fn()
    except Exception as err:  # noqa: BLE001 - the exception's type and text are compared
        return type(err).__name__, str(err)
    return None


@pytest.mark.parametrize("case", ["x_1d", "x_3d", "y_1d", "y_width", "reduction", "exponent_small", "exponent_str"])
def test_validation_errors_match_jax(jax, case):
    x, y = _rows(29)
    kwargs, name = {}, "linear_similarity"
    if case == "x_1d":
        x = x[0]
    elif case == "x_3d":
        x = x[None]
    elif case == "y_1d":
        y = y[0]
    elif case == "y_width":
        y = y[:, :5]
    elif case == "reduction":
        kwargs["reduction"] = "max"
    else:
        name, kwargs["exponent"] = "minkowski_distance", 0.5 if case == "exponent_small" else "2"
    ours = _outcome(lambda: _call(pf, name, torch.from_numpy(x), torch.from_numpy(y), **kwargs))
    theirs = _outcome(lambda: _call(jax.f, name, x, y, **kwargs))
    assert ours is not None and theirs is not None
    assert ours[0] == theirs[0]
    if case in ("x_1d", "x_3d"):  # the shape prints as a tuple in the port, a JAX shape in JAX
        assert ours[1].split(" but got")[0] == theirs[1].split(" but got")[0]
    else:
        assert ours[1] == theirs[1]
    if case.startswith("exponent"):
        with pytest.raises(TorchMetricsUserError, match="greater than 1"):
            pf.pairwise_minkowski_distance(torch.from_numpy(x), exponent=0.5)


def test_tf32_setting_changes_nothing_and_is_restored():
    """A caller's ``set_float32_matmul_precision("high")``: every entry gives the bits of the default
    setting, and the setting reads "high" afterwards."""
    x, y = (torch.from_numpy(a) for a in _rows(31, n=64, m=48, d=96))
    before = {name: _call(pf, name, x, y) for name in NAMES}
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        after = {name: _call(pf, name, x, y) for name in NAMES}
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(old)
    for name in NAMES:
        assert torch.equal(before[name], after[name]), name
