"""The port's serve traces (``obs/trace.py``) against the JAX package's.

- The ring's bound and its exact drop count; ``mint`` is ``None`` while telemetry is off.
- A deterministic served sequence (the drain held, n enqueues, released, quiesced; a shed; a failed apply; an
  abandon) emits the same ordered ``(name, ph)`` list of serve events in both packages.
- ``validate_flows`` gives JAX's verdicts on the same event lists: a clean run, a dangling start, a duplicate
  start, and a committed flow that does not cross threads.
"""
from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import pytest

import torchmetrics_tpu_torch as port
from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.obs import trace
from torchmetrics_tpu_torch.serve import ServeOptions
from torchmetrics_tpu_torch.utils.exceptions import ServeError


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu as jt
    from torchmetrics_tpu import obs as jobs
    from torchmetrics_tpu.obs import trace as jtrace
    from torchmetrics_tpu.serve import ServeOptions as JServeOptions

    return SimpleNamespace(top=jt, obs=jobs, trace=jtrace, ServeOptions=JServeOptions)


def _b(v: float, size: int = 4):
    return np.full((size,), v, np.float32)


def test_ring_is_bounded_and_counts_drops():
    ring = trace.TraceRing(maxlen=4)
    for i in range(10):
        ring.push({"i": i})
    assert len(ring) == 4 and ring.dropped == 6
    assert [e["i"] for e in ring.events()] == [6, 7, 8, 9]
    ring.clear()
    assert len(ring) == 0 and ring.dropped == 0


def test_mint_is_none_and_nothing_recorded_while_disabled():
    with obs.enabled(False):
        trace.clear()
        assert trace.mint() is None
        m = port.SumMetric(device="cpu")
        t = m.update_async(_b(1.0))
        m.compute()
        assert t.trace_id is None
        assert trace.events() == []
        # the always-on series still record while tracing is off
        assert obs.telemetry.series("serve.queue_depth").count > 0
    with obs.enabled(True):
        assert isinstance(trace.mint(), int)


def _served_sequence(top, options_cls, obs_mod, trace_mod, device_kw):
    """The same served sequence in either package; returns the ordered ``(name, ph)`` list of serve events."""
    with obs_mod.enabled(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trace_mod.clear()
        # held drain, five enqueues, released, quiesced: one window of 4 and one of 1
        m = top.SumMetric(**device_kw)
        eng = m.serve(options_cls(max_inflight=64, coalesce=16))
        eng.pause()
        for i in range(5):
            m.update_async(_b(float(i)))
        eng.resume()
        eng.quiesce()
        # a shed: the third enqueue against a held window of two
        m2 = top.SumMetric(**device_kw)
        eng2 = m2.serve(options_cls(max_inflight=2, on_full="shed"))
        eng2.pause()
        for i in range(3):
            m2.update_async(_b(float(i)))
        eng2.resume()
        eng2.quiesce()
        # a failed apply: a string batch past the caller (no validation)
        m3 = top.classification.MulticlassAccuracy(num_classes=3, validate_args=False, **device_kw)
        eng3 = m3.serve(options_cls(max_inflight=64))
        eng3.pause()
        m3.update_async(np.asarray(["bogus"]), np.asarray([0], np.int32))
        eng3.resume()
        with pytest.raises(Exception, match="failed to apply"):
            eng3.quiesce()
        # an abandon with two batches in the held window
        m4 = top.SumMetric(**device_kw)
        eng4 = m4.serve(options_cls(max_inflight=64))
        eng4.pause()
        m4.update_async(_b(1.0))
        m4.update_async(_b(2.0))
        eng4.abandon()
        events = [e for e in trace_mod.events() if e.get("cat") == "serve"]
    return [(e["name"], e["ph"]) for e in events], trace_mod.validate_flows(trace_mod.events())


def test_served_sequence_matches_jax(jax, tmp_path):
    with obs.bundle.capture_dir(tmp_path / "port"), jax.obs.bundle.capture_dir(str(tmp_path / "jax")):
        ours, ours_flows = _served_sequence(port, ServeOptions, obs, trace, {"device": "cpu"})
        theirs, theirs_flows = _served_sequence(jax.top, jax.ServeOptions, jax.obs, jax.trace, {})
    assert ours == theirs
    assert ours_flows == theirs_flows
    assert ours_flows["valid"] and ours_flows["flows"] == 10 and ours_flows["committed_flows"] == 7
    assert ours.count(("serve.stage.shed", "i")) == 1
    assert ours.count(("serve.stage.abandoned", "i")) == 2
    assert ours.count(("serve.stage.failed", "i")) == 1
    assert ours.count(("serve.stage.coalesced", "i")) == 6  # the window of 4 and the shed lane's window of 2


def _ev(ph, flow_id, tid, name="serve.ticket", **args):
    e = {"name": name, "cat": "serve", "ph": ph, "ts": 0.0, "pid": 1, "tid": tid}
    if flow_id is not None:
        e["id"] = flow_id
    if args:
        e["args"] = args
    return e


VERDICT_CASES = {
    "clean": [_ev("s", 1, 10), _ev("i", None, 20, name="serve.stage.committed", ticket=1), _ev("f", 1, 20)],
    "dangling_start": [_ev("s", 1, 10), _ev("s", 2, 10), _ev("f", 1, 20)],
    "duplicate_start": [_ev("s", 1, 10), _ev("s", 1, 10), _ev("f", 1, 20)],
    "not_cross_thread": [_ev("s", 1, 10), _ev("i", None, 10, name="serve.stage.committed", ticket=1),
                         _ev("f", 1, 10)],
    "orphan_and_doubled": [_ev("s", 1, 10), _ev("f", 1, 20), _ev("f", 1, 20), _ev("f", 3, 20)],
}


@pytest.mark.parametrize("case", sorted(VERDICT_CASES))
def test_validate_flows_verdicts_match_jax(jax, case):
    events = VERDICT_CASES[case]
    ours = trace.validate_flows(events)
    assert ours == jax.trace.validate_flows(events)
    assert ours["valid"] is (case == "clean")


def test_trace_ids_pair_caller_and_drain_threads():
    with obs.enabled():
        trace.clear()
        m = port.SumMetric(device="cpu")
        tickets = [m.update_async(_b(1.0)) for _ in range(3)]
        m.compute()
        assert all(isinstance(t.trace_id, int) for t in tickets)
        evidence = trace.validate_flows(trace.events())
    assert evidence["valid"] and evidence["flows"] == 3 and evidence["committed_cross_thread"] == 3


def test_fence_break_is_traced():
    with obs.enabled(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        trace.clear()
        m = port.SumMetric(device="cpu")
        eng = m.serve(ServeOptions(max_inflight=64))
        m.update_async(_b(1.0)).result(timeout=2.0)
        eng.pause()
        m.update_async(_b(1.0))
        m._state.bump_generation()
        eng.resume()
        eng.quiesce()
        names = [e["name"] for e in trace.events()]
    assert "serve.stage.fence_break" in names
    with pytest.raises(ServeError, match="abandoned"):
        eng.abandon()
        m.update_async(_b(1.0))
