"""Deferred accumulation of the PyTorch port (``Metric.buffered``, ``MetricCollection.buffered``)
against the JAX package's, case by case as ``tests/unittests/bases/test_fast_dispatch.py:202-312``
pins them: the pending guard, the flush at ``k``, the context manager, the flush on a shape change,
the error exit's drop and warning, a failed flush disarming the guard, and a buffered collection
equal to per-batch updates.

Each case runs on the eager tier and on the graph tier's bookkeeping (``dispatch.EMULATE_ON_CPU``),
and feeds the same numpy batches to the JAX package. Sums of ones are exact; the collection's
values match within rtol=1e-6, atol=1e-7 (float32 ratios in both).
"""
from __future__ import annotations

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchmetrics_tpu.aggregation as ja
import torchmetrics_tpu.classification as jc
import torchmetrics_tpu_torch.classification as tc
from torchmetrics_tpu import MetricCollection as JaxCollection
from torchmetrics_tpu_torch import MetricCollection
from torchmetrics_tpu_torch.aggregation import SumMetric
from torchmetrics_tpu_torch.ops import dispatch
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

TIERS = ["eager", "graph"]


@pytest.fixture(params=TIERS)
def tier(request, monkeypatch):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", request.param == "graph")
    return request.param


def _ones(n: int) -> np.ndarray:
    return np.ones(n, np.float32)


def _both(make_port, make_jax, drive):
    """``drive(metric, as_input)`` on the port and on the JAX package; the two computes."""
    port, theirs = make_port(), make_jax()
    drive(port, lambda x: torch.from_numpy(x))
    drive(theirs, jnp.asarray)
    return port.compute(), theirs.compute()


def test_pending_buffer_blocks_direct_access(tier):
    m = SumMetric(device="cpu")
    buf = m.buffered(4)
    buf.update(torch.ones(4))
    for op in (m.compute, lambda: m.update(torch.ones(4)), lambda: m(torch.ones(4)),
               lambda: m.update_batches(torch.ones(2, 4))):
        with pytest.raises(TorchMetricsUserError, match="pending"):
            op()
    with pytest.raises(TorchMetricsUserError, match="pending"):
        _ = m.metric_state
    buf.flush()
    assert float(m.compute()) == 4.0


def test_auto_flush_at_k_and_context_manager(tier):
    pending = []

    def drive(m, conv):
        with m.buffered(2) as buf:
            buf.update(conv(_ones(4)))
            pending.append(buf.pending)
            buf.update(conv(_ones(4)))
            pending.append(buf.pending)  # k reached: flushed
            buf.update(conv(_ones(4)))
        pending.append(buf.pending)  # the context exit flushed the tail

    ours, theirs = _both(lambda: SumMetric(device="cpu"), ja.SumMetric, drive)
    assert pending == [1, 0, 0] * 2
    assert float(ours) == float(theirs) == 12.0


def test_shape_change_flushes_pending_stack(tier):
    pending = []

    def drive(m, conv):
        buf = m.buffered(8)
        buf.update(conv(_ones(4)))
        buf.update(conv(_ones(6)))  # ragged: the pending stack flushes first
        pending.append(buf.pending)
        buf.flush()

    ours, theirs = _both(lambda: SumMetric(device="cpu"), ja.SumMetric, drive)
    assert pending == [1, 1] and float(ours) == float(theirs) == 10.0


def test_error_exit_drops_pending_batches(tier):
    m = SumMetric(device="cpu")
    with pytest.raises(ValueError, match="boom"):
        with m.buffered(8) as buf:
            buf.update(torch.ones(4))
            raise ValueError("boom")
    assert buf.pending == 0
    with pytest.warns(UserWarning, match="before the ``update``"):
        assert float(m.compute()) == 0.0  # the half window was not flushed into the state


def test_error_exit_warns_and_leaves_metric_usable(tier):
    m = SumMetric(device="cpu")
    m.update(torch.ones(4))  # what came before the error survives
    with pytest.warns(UserWarning, match="discarded 2 pending"):
        with pytest.raises(RuntimeError, match="loop died"):
            with m.buffered(8) as buf:
                buf.update(torch.ones(4))
                buf.update(torch.ones(4))
                raise RuntimeError("loop died")
    assert m._buffered_pending == 0
    m.update(torch.ones(4))
    assert float(m.compute()) == 8.0
    _ = m.metric_state


def test_failed_flush_on_clean_exit_disarms_guard(tier):
    m = SumMetric(device="cpu")

    def explode(*args, **kwargs):
        raise RuntimeError("injected flush failure")

    with pytest.raises(RuntimeError, match="injected flush failure"):
        with m.buffered(8) as buf:
            buf.update(torch.ones(4))
            buf.update(torch.ones(4))
            m.update_batches = explode  # the flush itself dies
    assert m._buffered_pending == 0  # the guard does not stay armed behind the error
    del m.__dict__["update_batches"]
    m.update(torch.ones(4))
    assert float(m.compute()) == 4.0


def test_error_exit_with_no_pending_does_not_warn(tier):
    m = SumMetric(device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any warning fails the test
        with pytest.raises(ValueError, match="boom"):
            with m.buffered(2) as buf:
                buf.update(torch.ones(4))
                buf.update(torch.ones(4))  # k reached: flushed, nothing pending
                raise ValueError("boom")
    assert float(m.compute()) == 8.0


def test_buffered_needs_a_positive_k():
    with pytest.raises(ValueError, match="k >= 1"):
        SumMetric(device="cpu").buffered(0)


@pytest.mark.parametrize("k", [1, 3, 32])
def test_collection_buffered_matches_updates_and_jax(tier, k):
    def members(pkg, **kw):
        return [pkg.MulticlassAccuracy(num_classes=5, average="micro", validate_args=False, **kw),
                pkg.MulticlassF1Score(num_classes=5, average="macro", validate_args=False, **kw)]

    rng = np.random.RandomState(11)
    batches = [(rng.randint(0, 5, 64).astype(np.int32), rng.randint(0, 5, 64).astype(np.int32)) for _ in range(7)]
    buffered, stepped, theirs = MetricCollection(members(tc, device="cpu")), MetricCollection(members(tc, device="cpu")), \
        JaxCollection(members(jc))
    buf, jbuf = buffered.buffered(k), theirs.buffered(k)
    for p, t in batches:
        buf.update(torch.from_numpy(p), torch.from_numpy(t))
        stepped.update(torch.from_numpy(p), torch.from_numpy(t))
        jbuf.update(jnp.asarray(p), jnp.asarray(t))
    ours, step_values, jax_values = buf.compute(), stepped.compute(), jbuf.compute()
    for name in ours:
        assert torch.equal(ours[name], step_values[name]), name
        np.testing.assert_allclose(ours[name].numpy(), np.asarray(jax_values[name]), rtol=1e-6, atol=1e-7, err_msg=name)
    for key in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(buffered["MulticlassF1Score"].metric_state[key].numpy(),
                                      np.asarray(theirs["MulticlassF1Score"].metric_state[key]))
