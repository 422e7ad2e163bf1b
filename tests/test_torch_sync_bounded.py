"""The port's bounded sync (``parallel/sync.py``: deadlines, retries with backoff, quorum, degraded and strict
modes, the rank health ledger) against the JAX package's, on the same fault schedules.

Holds the contracts of JAX's ``tests/unittests/robust/test_sync_bounded.py``, ``test_quorum_sync.py``,
``test_uneven_gather.py`` (ragged ``cat`` pieces through ``process_sync``) and ``test_backoff_jitter.py``: each
schedule (a partial-capable gather that raises ``SyncTimeoutError`` with the responses that arrived, a healthy
gather, a ``CollectiveTimeout`` straggler) goes through both packages' ``process_sync`` from the same numpy
states, and the grades, responders, ``degraded_states``/``quorum_states``, warnings and values must agree, the
values bit for bit (integer states and integer-valued floats; the float rescale too, as both scale by
``world/k`` in float32). ``time.sleep`` is patched in both packages, so no test sleeps for a backoff, and the
pauses it records under ``TM_TPU_CHAOS_SEED=1234`` must be the same list. JAX imports stay inside fixtures.
"""
from __future__ import annotations

import time
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch as port
from torchmetrics_tpu_torch.parallel import sync as sync_mod
from torchmetrics_tpu_torch.robust import chaos
from torchmetrics_tpu_torch.utils.exceptions import SyncTimeoutError

F32 = np.float32
#: the bounded options of JAX's tests (``test_sync_bounded.py:21-22``)
FAST = dict(timeout_s=0.5, retries=1, backoff_s=0.01, degraded_mode=True)
STRICT = dict(timeout_s=0.5, retries=1, backoff_s=0.01, degraded_mode=False)

#: name -> (state, reductions, gather schedule, SyncOptions keywords). A gather schedule is
#: ("partial", {rank: array, or None for the caller's own payload}), ("good", {state: [the other ranks' arrays]}),
#: ("timeout", fail_attempts) or ("none",) for the default gather
SCHEDULES = {
    "sum_rescaled_to_world": ({"total": F32(5.0)}, {"total": "sum"}, ("partial", {0: None, 1: F32(7.0)}),
                              dict(world=4, quorum=2)),
    "sum_exact_partial": ({"total": F32(5.0)}, {"total": "sum"}, ("partial", {0: None, 1: F32(7.0)}),
                          dict(world=4, quorum=2, quorum_rescale=False)),
    "float_rescale_by_3_over_2": ({"total": np.asarray([0.1, 0.2, 1e7 + 1], F32)}, {"total": "sum"},
                                  ("partial", {0: None, 2: np.asarray([0.7, 0.3, 3.0], F32)}),
                                  dict(world=3, quorum=2)),
    "int_count_keeps_dtype": ({"n": np.int32(5)}, {"n": "sum"}, ("partial", {0: None, 1: np.int32(3)}),
                              dict(world=3, quorum=1)),
    "int_rescale_by_5_over_3": ({"n": np.arange(0, 3000, 7, dtype=np.int32)}, {"n": "sum"},
                                ("partial", {0: None, 1: np.arange(1, 3001, 7, dtype=np.int32),
                                             3: np.arange(2, 3002, 7, dtype=np.int32)}),
                                dict(world=5, quorum=3)),
    "int_count_above_2_24": ({"n": np.asarray([2**24 + 1, 2**24 + 3, 7], np.int32)}, {"n": "sum"},
                             ("partial", {0: None}), dict(world=2, quorum=1)),
    "mean_over_responders": ({"avg": F32(3.0)}, {"avg": "mean"}, ("partial", {0: None, 1: F32(9.0)}),
                             dict(world=4, quorum=2)),
    "max_min_exact_over_subset": ({"hi": F32(4.0), "lo": F32(13.0)}, {"hi": "max", "lo": "min"},
                                  ("partial", {0: None, 2: F32(11.0)}), dict(world=4, quorum=2)),
    "cat_ragged_responders": ({"vals": [np.asarray([1.0, 2.0], F32)]}, {"vals": "cat"},
                              ("partial", {0: None, 2: np.asarray([7.0, 8.0, 9.0], F32)}), dict(world=3, quorum=2)),
    "self_alone_local_or_quorum": [({"total": F32(5.0)}, {"total": "sum"}, ("partial", {0: None}),
                                    dict(world=4, quorum=3)),
                                   ({"avg": F32(5.0)}, {"avg": "mean"}, ("partial", {}), dict(world=4, quorum=2)),
                                   ({"avg": F32(5.0)}, {"avg": "mean"}, ("partial", {}), dict(world=4, quorum=1))],
    "single_rank_world_quorum_noop": ({"total": F32(5.0)}, {"total": "sum"}, ("none",), dict(quorum=2)),
    "full_world_ragged_cat": ({"vals": [np.asarray([0.0, 1.0], F32)], "n": np.int32(2)},
                              {"vals": "cat", "n": "sum"},
                              ("good", {"vals": [np.asarray([10.0, 11.0, 12.0, 13.0], F32), np.zeros((0,), F32)],
                                        "n": [np.int32(7), np.int32(0)]}),
                              dict(world=3, quorum=2)),
    "bounded_retry_keeps_partial": ({"total": F32(5.0)}, {"total": "sum"}, ("partial", {0: None, 1: F32(7.0)}),
                                    dict(timeout_s=0.5, retries=1, backoff_s=0.01, world=4, quorum=2)),
    "transient_failure_retried": ({"total": F32(5.0)}, {"total": "sum"}, ("timeout", 1), FAST),
    "exhaustion_degrades_to_local": ({"total": F32(5.0), "vals": [np.asarray([1.0, 2.0], F32)]},
                                     {"total": "sum", "vals": "cat"}, ("timeout", 99), FAST),
    "strict_raises": ({"total": F32(5.0)}, {"total": "sum"}, ("timeout", 99), STRICT),
}


def _side(sync, chaos_mod, ste, prints, to_arr, to_np, sum_metric):
    return SimpleNamespace(sync=sync, chaos=chaos_mod, STE=ste, prints=prints, arr=to_arr, np=to_np,
                           SumMetric=sum_metric)


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from torchmetrics_tpu.aggregation import SumMetric as JaxSum
    from torchmetrics_tpu.parallel import sync as jsync
    from torchmetrics_tpu.robust import chaos as jchaos
    from torchmetrics_tpu.utils import prints as jprints
    from torchmetrics_tpu.utils.exceptions import SyncTimeoutError as JaxSTE

    return _side(jsync, jchaos, JaxSTE, jprints, jnp.asarray, np.asarray, JaxSum)


def _port_side():
    from torchmetrics_tpu_torch.utils import prints

    def to_np(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    return _side(sync_mod, chaos, SyncTimeoutError, prints, lambda a: torch.from_numpy(np.array(a)), to_np,
                 lambda **kw: port.SumMetric(device="cpu", **kw))


PORT = _port_side()


def _gather(side, schedule):
    kind = schedule[0]
    if kind == "partial":
        answers = schedule[1]

        def gather(value, group=None, *, name=None):
            resp = {r: value if a is None else side.arr(a) for r, a in answers.items()}
            raise side.STE("chaos: peers timed out", responses=resp)

        return gather
    if kind == "good":
        others = schedule[1]
        return lambda value, group=None, *, name=None: [value] + [side.arr(a) for a in others[name]]
    if kind == "timeout":
        return side.chaos.CollectiveTimeout(fail_attempts=schedule[1], hang_s=None)
    return None


def _run(side, case, pauses):
    """One schedule through one package: (outcome dict, warnings' texts, the backoff pauses it slept)."""
    state, reductions, schedule, options = case
    side.sync.reset_health_state()
    side.prints.reset_warning_cache()
    st = {k: [side.arr(e) for e in v] if isinstance(v, list) else side.arr(v) for k, v in state.items()}
    gather = _gather(side, schedule)
    del pauses[:]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            out = side.sync.process_sync(st, reductions, gather_fn=gather,
                                         options=side.sync.SyncOptions(**options))
        except side.STE as err:
            return {"raised": str(err)}, [str(w.message) for w in caught], list(pauses)
    values = {k: [side.np(e) for e in v] if isinstance(v, list) else side.np(v) for k, v in out.items()}
    outcome = {
        "grade": str(out.world_consistent), "bool": bool(out.world_consistent),
        "degraded": tuple(out.degraded_states), "quorum": tuple(out.quorum_states),
        "responding": {k: tuple(v) for k, v in out.responding_ranks.items()} if options.get("world") else None,
        "readmitted": tuple(out.readmitted_ranks), "values": values,
        "calls": getattr(gather, "calls", None),
    }
    return outcome, [str(w.message) for w in caught], list(pauses)


def _same_values(a, b):
    """``a`` (the port's) equals ``b`` (JAX's) bit for bit. A list state's empty pieces are left out of ``b``: the
    port's ``process_sync`` drops them, which changes no concatenated value."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], list):
            b[k] = [y for y in b[k] if y.ndim == 0 or y.shape[0] > 0]
            assert len(a[k]) == len(b[k]), k
            for x, y in zip(a[k], b[k]):
                assert x.shape == y.shape and x.tobytes() == y.astype(x.dtype).tobytes(), k
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.shape == y.shape and x.dtype.kind == y.dtype.kind, k
            assert np.array_equal(x, y.astype(x.dtype)) and x.tobytes() == y.astype(x.dtype).tobytes(), (k, x, y)


@pytest.fixture
def recorded_pauses(monkeypatch):
    """``time.sleep`` recording its pauses instead of sleeping (both packages call ``time.sleep``)."""
    pauses: list = []
    monkeypatch.setattr(time, "sleep", lambda s: pauses.append(s))
    monkeypatch.setenv("TM_TPU_CHAOS_SEED", "1234")
    return pauses


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_schedule_matches_jax(jax_side, recorded_pauses, case):
    """Grades, responders, degraded and quorum states, warnings, values (bit for bit), the straggler's call count
    and the backoff pauses equal JAX's; the strict schedule raises in both with the state's name."""
    runs = SCHEDULES[case] if isinstance(SCHEDULES[case], list) else [SCHEDULES[case]]
    for run in runs:
        jax_side.sync.reset_backoff_rng()
        theirs, their_warn, their_pauses = _run(jax_side, run, recorded_pauses)
        sync_mod.reset_backoff_rng()
        ours, our_warn, our_pauses = _run(PORT, run, recorded_pauses)
        if "raised" in theirs:
            assert "raised" in ours and "'total'" in ours["raised"] and "'total'" in theirs["raised"]
            assert ours["raised"] == theirs["raised"]
        else:
            _same_values(ours.pop("values"), theirs.pop("values"))
            assert ours == theirs
        assert our_pauses == their_pauses
        for key in ("QUORUM", "LOCAL state", "exact partial sums", "rescaled full-world estimates"):
            assert any(key in w for w in our_warn) == any(key in w for w in their_warn), key
    sync_mod.reset_health_state()


def test_backoff_pauses_match_jax_with_and_without_jitter(jax_side, recorded_pauses):
    """Under ``TM_TPU_CHAOS_SEED=1234`` three failed attempts give the same three jittered pauses in both packages
    (decorrelated: drawn from ``[backoff_s, 3 * previous]``, not the ladder); with jitter off both pause on the
    exponential ladder ``backoff_s * 2**k``; a re-pinned seed replays the jittered list."""
    lists = {}
    for jitter in (True, False):
        for name, side in (("jax", jax_side), ("port", PORT)):
            for repeat in range(2):
                side.sync.reset_backoff_rng()
                del recorded_pauses[:]
                gather = side.chaos.CollectiveTimeout(fail_attempts=3, hang_s=None)
                opts = side.sync.SyncOptions(timeout_s=5.0, retries=4, backoff_s=0.005, backoff_jitter=jitter,
                                             world=1)
                out = side.sync.process_sync({"s": side.arr(np.asarray([1.0, 2.0], F32))}, {"s": "sum"},
                                             gather_fn=gather, options=opts)
                assert bool(out.world_consistent) and gather.calls == 4
                lists[(jitter, name, repeat)] = list(recorded_pauses)
    for jitter in (True, False):
        assert lists[(jitter, "port", 0)] == lists[(jitter, "jax", 0)] == lists[(jitter, "port", 1)]
    assert lists[(False, "port", 0)] == [0.005, 0.01, 0.02]
    assert lists[(True, "port", 0)] != lists[(False, "port", 0)]
    assert all(0.005 <= p for p in lists[(True, "port", 0)])


def _flap_sequence(side, clock):
    """A 3-rank world where rank 1 flaps for four syncs, then heals: per sync, the gather group asked for, the
    grade, the evicted and re-admitted ranks, the value and the ledger's report (latencies left out)."""
    asked = []
    healthy = {"now": False}

    def gather(value, group=None, *, name=None, ranks=None):
        asked.append(tuple(ranks))
        responses = {r: value for r in ranks if r != 1 or healthy["now"]}
        if len(responses) < len(ranks):
            raise side.STE("rank 1 flapping", responses=responses)
        return [responses[r] for r in ranks]

    side.sync.reset_health_state()
    opts = side.sync.SyncOptions(world=3, quorum=1, evict_after=2, probe_backoff_s=0.01)
    seq = []
    for step in range(8):
        healthy["now"] = step >= 5
        clock["now"] += 0.006  # a probe is due 0.01 s after the eviction, and 0.02 s after a failed probe
        side.prints.reset_warning_cache()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = side.sync.process_sync({"total": side.arr(np.asarray([1.0, 3.0], F32))}, {"total": "sum"},
                                         gather_fn=gather, options=opts)
        report = {r: {k: v for k, v in h.items() if k != "latency_ewma_us"}
                  for r, h in side.sync.health_ledger().report().items()}
        seq.append((asked[-1], str(out.world_consistent), side.sync.health_ledger().evicted_ranks(),
                    tuple(out.readmitted_ranks), side.np(out["total"]).tolist(), report))
    side.sync.reset_health_state()
    return seq


def test_ledger_eviction_and_probe_sequence_matches_jax(jax_side, monkeypatch):
    """A flapping rank is evicted after ``evict_after`` = 2 misses, left out of the gather group (quorum grade,
    the sum rescaled over the two answering ranks), probed when its backoff has passed (a failed probe doubles
    it), and re-admitted by the first probe it answers: the same sequence, step for step, in both packages,
    under one fake monotonic clock."""
    clock = {"now": 1000.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["now"])
    theirs = _flap_sequence(jax_side, clock)
    ours = _flap_sequence(PORT, clock)
    assert ours == theirs
    grades = [s[1] for s in ours]
    assert grades[0] == grades[1] == "quorum" and grades[-1] == "full"
    assert ours[2][2] == (1,) and 1 not in ours[2][0]  # evicted: out of the gather group
    assert any(s[3] == (1,) for s in ours)  # re-admitted by a probe


ENVS = [
    {}, {"TM_TPU_SYNC_TIMEOUT_S": "1.5", "TM_TPU_SYNC_RETRIES": "4", "TM_TPU_SYNC_BACKOFF_S": "0.2",
         "TM_TPU_SYNC_DEGRADED": "off"},
    {"TM_TPU_SYNC_QUORUM": "0.75", "TM_TPU_SYNC_EVICT_AFTER": "5", "TM_TPU_SYNC_PROBE_BACKOFF_S": "0.5",
     "TM_TPU_SYNC_JITTER": "0", "TM_TPU_SYNC_COMPRESSION": "zip"},
    {"TM_TPU_SYNC_QUORUM": "3"},
    {"TM_TPU_SYNC_QUORUM": "nope", "TM_TPU_SYNC_TIMEOUT_S": "x", "TM_TPU_SYNC_JITTER": "False"},
]


def test_env_options_parse_as_jax(jax_side, monkeypatch):
    """``sync_options_from_env`` reads the ``TM_TPU_SYNC_*`` knobs as JAX's does, field for field, for unset,
    bounded-strict, quorum-and-breaker and invalid settings (an invalid compression falls back to ``"none"`` in
    both); a known codec raises in the port, naming item 9b."""
    names = sorted({k for env in ENVS for k in env} | {"TM_TPU_SYNC_COMPRESSION"})
    for env in ENVS:
        for k in names:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        theirs, ours = jax_side.sync.sync_options_from_env(), sync_mod.sync_options_from_env()
        fields = [f for f in vars(theirs)]
        assert [getattr(ours, f) for f in fields] == [getattr(theirs, f) for f in fields], env
        assert ours.bounded == theirs.bounded
    assert [getattr(sync_mod, n) for n in dir(sync_mod) if n.startswith("ENV_SYNC_")] == \
        [getattr(jax_side.sync, n) for n in dir(sync_mod) if n.startswith("ENV_SYNC_")]
    monkeypatch.setenv("TM_TPU_SYNC_COMPRESSION", "int8")
    with pytest.raises(NotImplementedError, match="item 9b"):
        sync_mod.sync_options_from_env()


def test_metric_compute_degrades_then_recovers_as_jax(jax_side, monkeypatch):
    """Through ``Metric.compute``: a dead peer under the env's bounded options gives the local value graded
    ``local`` and ``reset`` grades ``full`` again; a peer missing once gives the quorum estimate, then a healthy
    world gives ``full`` with the stale flags cleared (JAX ``test_sync_bounded.py:97``,
    ``test_quorum_sync.py:219``). Values, grades and ``telemetry["sync"]``'s state lists equal JAX's."""
    monkeypatch.setenv("TM_TPU_SYNC_TIMEOUT_S", "0.3")
    monkeypatch.setenv("TM_TPU_SYNC_RETRIES", "1")
    monkeypatch.setattr(time, "sleep", lambda s: None)

    def drive(side):
        side.prints.reset_warning_cache()
        out = []
        dead = side.chaos.CollectiveTimeout(fail_attempts=99, hang_s=None)
        m = side.SumMetric(dist_sync_fn=dead, distributed_available_fn=lambda: True)
        m.update(np.ones(4, F32))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out.append((float(m.compute()), str(m.world_consistent)))
        m.reset()
        out.append(str(m.world_consistent))
        calls = {"n": 0}

        def flaky(value, group=None, *, name=None):
            calls["n"] += 1
            if calls["n"] == 1:
                raise side.STE("peer down", responses={0: value})
            return [value, value * 0]

        m = side.SumMetric(dist_sync_fn=flaky, distributed_available_fn=lambda: True,
                           sync_options=side.sync.SyncOptions(world=2, quorum=1))
        m.update(np.ones(4, F32))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out.append((float(m.compute()), str(m.world_consistent), m.telemetry["sync"]["quorum_states"]))
        m.update(np.ones(2, F32))
        out.append((float(m.compute()), str(m.world_consistent), m.telemetry["sync"]["quorum_states"],
                    m.telemetry["sync"]["degraded_states"]))
        return out

    theirs, ours = drive(jax_side), drive(PORT)
    assert ours == theirs
    assert ours[0] == (4.0, "local") and ours[2][:2] == (8.0, "quorum") and ours[3][:2] == (6.0, "full")
