"""The port's ``utils`` surface against the JAX package's (queue C, C6), and ``ops``' re-exports.

``torchmetrics_tpu_torch.utils`` exports the JAX package's 23 names. The ones the port lacked before (``auc``,
``interp``, ``is_traced``, ``rank_zero_info``, ``rank_zero_debug``) and the helpers beside them (``DataType``,
``AverageMethod``, ``MDMCAverageMethod``, ``check_forward_full_state_property``, ``reset_warning_cache``,
``plot.style_change``, ``SyncTimeoutError``) are held to JAX's on the same seeded numpy inputs: ``auc`` within
1e-6 relative (XLA sums the trapezoids in its own order), ``interp`` within 1e-6 of the largest ``|fp|`` (XLA may contract
the multiply-add, and a value near 0 cancels), the enums member for member. ``ops`` re-exports eight of JAX's nine ``ops``
names; ``ops.bincount`` stays the K1 module, a difference kept on purpose. JAX imports stay inside fixtures.
"""
from __future__ import annotations

import io
import logging
import warnings
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as port
import torchmetrics_tpu_torch.ops as ops
import torchmetrics_tpu_torch.utils as utils
from torchmetrics_tpu_torch.utils import auc, interp, is_traced  # the import that raised ImportError (C6)
from torchmetrics_tpu_torch.utils import enums, prints
from torchmetrics_tpu_torch.utils.exceptions import SyncTimeoutError, TorchMetricsUserError


@pytest.fixture(scope="module")
def jax_utils():
    pytest.importorskip("jax")
    import torchmetrics_tpu.utils as jutils

    return jutils


def test_utils_exports_jax_s_23_names(jax_utils):
    assert sorted(utils.__all__) == sorted(jax_utils.__all__) and len(utils.__all__) == 23
    for name in utils.__all__:
        ours, theirs = getattr(utils, name), getattr(jax_utils, name)
        assert callable(ours) and type(ours) is type(theirs) or isinstance(ours, type), name
    assert {auc, interp, is_traced} <= {getattr(utils, n) for n in utils.__all__}


@pytest.mark.parametrize("reorder", [False, True])
def test_auc_matches_jax(jax_utils, reorder):
    """Trapezoids over seeded curves (ascending, descending, tied x under ``reorder``), within 1e-6 relative."""
    import jax.numpy as jnp

    rng = np.random.default_rng(21)
    cases = [np.sort(rng.random(50)).astype(np.float32), np.sort(rng.random(50))[::-1].astype(np.float32),
             np.repeat(rng.random(10), 3).astype(np.float32)]
    for x in cases:
        y = rng.random(x.shape[0]).astype(np.float32)
        ours = auc(torch.from_numpy(x.copy()), torch.from_numpy(y), reorder=reorder).numpy()
        theirs = np.asarray(jax_utils.auc(jnp.asarray(x), jnp.asarray(y), reorder=reorder))
        np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-7)


def test_interp_matches_jax(jax_utils):
    """``jnp.interp``'s arithmetic: inside, outside both ends, on the knots, over a zero-width segment and over
    integer knots, within 1e-6 of the largest ``|fp|``."""
    import jax.numpy as jnp

    rng = np.random.default_rng(22)
    xp = np.sort(rng.random(40) * 10).astype(np.float32)
    xp[7] = xp[6]  # a zero-width segment
    fp = rng.standard_normal(40).astype(np.float32)
    x = np.concatenate([rng.random(200) * 12 - 1, xp[:5], [xp[0], xp[-1]]]).astype(np.float32)
    for knots in (xp, np.arange(40, dtype=np.int64)):
        ours = interp(torch.from_numpy(x), torch.from_numpy(knots), torch.from_numpy(fp)).numpy()
        theirs = np.asarray(jax_utils.interp(jnp.asarray(x), jnp.asarray(knots), jnp.asarray(fp)))
        assert ours.dtype == theirs.dtype
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6 * float(np.abs(fp).max()))
    with pytest.raises(ValueError, match="one-dimensional"):
        interp(torch.zeros(3), torch.zeros(3), torch.zeros(4))


def test_is_traced_outside_a_capture(jax_utils):
    """Outside a graph capture nothing is traced: CPU tensors, numpy arrays, numbers and no argument at all, as
    JAX's ``is_traced`` answers outside ``jit`` (the card test holds the inside of a capture)."""
    args = (torch.ones(3), np.ones(3), 1.0)
    assert not is_traced(*args) and not is_traced()
    assert not jax_utils.is_traced(*args) and not jax_utils.is_traced()


@pytest.mark.cuda
def test_is_traced_inside_a_capture_on_the_card():
    """On the card, ``is_traced`` is True for a tensor on the stream being captured and False outside the
    capture. Run there with ``python -m pytest --noconftest tests/test_torch_utils.py -m cuda``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a graph capture is the port's counterpart of a trace")
    x = torch.ones(4, device="cuda")
    seen = []
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.cuda.graph(graph):
        y = x * 2
        seen.append(is_traced(y, 1.0))
    assert seen == [True] and not is_traced(y)


@pytest.mark.parametrize("name", ["DataType", "AverageMethod", "MDMCAverageMethod"])
def test_enums_match_jax(name):
    pytest.importorskip("jax")
    import torchmetrics_tpu.utils.enums as jenums

    ours, theirs = getattr(enums, name), getattr(jenums, name)
    assert [(m.name, m.value) for m in ours] == [(m.name, m.value) for m in theirs]
    assert ours._name() == theirs._name()
    for member in theirs:
        key = member.name.lower().replace("_", "-")
        assert ours.from_str(key).name == theirs.from_str(key).name
        if member.value is not None:
            assert str(ours[member.name]) == str(member)
    with pytest.raises(ValueError) as mine:
        ours.from_str("nope")
    with pytest.raises(ValueError) as jax_err:
        theirs.from_str("nope")
    assert str(mine.value) == str(jax_err.value)


def test_rank_zero_info_debug_and_the_warning_cache(caplog):
    """``rank_zero_info``/``rank_zero_debug`` log on rank 0 at their levels; ``reset_warning_cache`` is a no-op
    while the port keeps its "one-shot warnings" difference: a warning fires again without it."""
    with caplog.at_level(logging.DEBUG, logger="torchmetrics_tpu_torch"):
        prints.rank_zero_info("an info line")
        prints.rank_zero_debug("a debug line")
    assert [(r.levelno, r.getMessage()) for r in caplog.records] == [(logging.INFO, "an info line"),
                                                                    (logging.DEBUG, "a debug line")]
    assert prints.reset_warning_cache() is None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        prints.rank_zero_warn("twice", UserWarning)
        prints.rank_zero_warn("twice", UserWarning)
    assert [str(w.message) for w in caught] == ["twice", "twice"]


def test_check_forward_full_state_property_reports_as_jax(jax_utils):
    """Both packages profile ``SumMetric`` and print the same report lines (times aside): agreement of the two
    forwards, the full- and reduce-state timings per step count, the fused sweep against the loop."""
    import jax.numpy as jnp

    from torchmetrics_tpu.aggregation import SumMetric as JaxSum
    from torchmetrics_tpu.utils.checks import check_forward_full_state_property as jax_check

    def report(check, cls, init, value):
        out = io.StringIO()
        with redirect_stdout(out), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            check(cls, init_args=init, input_args={"value": value}, num_update_to_compare=(2, 3), reps=1)
        return [line.split(" took:")[0].split(" vs ")[0] for line in out.getvalue().splitlines()
                if not line.startswith("Recommended")]

    value = np.arange(4, dtype=np.float32)
    ours = report(utils.checks.check_forward_full_state_property, port.SumMetric, {"device": "cpu"},
                  torch.from_numpy(value))
    theirs = report(jax_check, JaxSum, {}, jnp.asarray(value))
    assert ours == theirs and len(ours) == 5


def test_style_change_is_jax_s(jax_utils):
    """``style_change`` is matplotlib's ``style.context`` where matplotlib is installed, as in JAX, else a no-op
    context manager (the machine with the card has no matplotlib)."""
    from torchmetrics_tpu.utils import plot as jplot

    from torchmetrics_tpu_torch.utils import plot

    if plot._MATPLOTLIB_AVAILABLE:
        import matplotlib.pyplot as plt

        assert plot.style_change is plt.style.context is jplot.style_change
    with plot.style_change("default"):
        pass


def test_ops_reexports_jax_s_names_but_bincount():
    """``ops`` re-exports JAX's ``ops.__all__`` less ``bincount``: ``ops.bincount`` stays the K1 module (a
    difference kept on purpose), and the counting entry is ``ops.histogram.bincount``."""
    pytest.importorskip("jax")
    import torchmetrics_tpu.ops as jops

    from torchmetrics_tpu_torch.ops import histogram, segments

    assert sorted(ops.__all__) == sorted(set(jops.__all__) - {"bincount"})
    assert type(ops.bincount).__name__ == "module" and ops.bincount.__name__ == "torchmetrics_tpu_torch.ops.bincount"
    for name in ops.__all__:
        assert getattr(ops, name) is getattr(histogram, name, None) or getattr(ops, name) is getattr(segments, name)
    counts = ops.bincount_weighted(torch.tensor([0, 2, 2, 1]), 4)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jops.bincount_weighted(np.asarray([0, 2, 2, 1]), 4)))


def test_sync_timeout_error_matches_jax():
    """``SyncTimeoutError`` is a ``TorchMetricsUserError`` that carries the partial ``responses``, as JAX's."""
    pytest.importorskip("jax")
    from torchmetrics_tpu.utils import exceptions as jexc

    err = SyncTimeoutError("sync of state 'x' timed out", responses={0: 1})
    assert isinstance(err, TorchMetricsUserError) and err.responses == {0: 1} and str(err) == "sync of state 'x' timed out"
    assert SyncTimeoutError("m").responses is None and jexc.SyncTimeoutError("m").responses is None
    assert [c.__name__ for c in SyncTimeoutError.__mro__] == [c.__name__ for c in jexc.SyncTimeoutError.__mro__]
