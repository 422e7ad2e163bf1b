"""Deterministic fault injection for the metric engine: the chaos harness (counterpart of
``torchmetrics_tpu/robust/chaos.py``).

Every failure class is a first-class, *seeded* injector that patches the REAL seam (no test double of the
engine):

===============================  ===========================================================================
:class:`AotCompileFailure`       a graph capture raises ``CaptureError``: the step's key must latch broken and
                                 run eagerly from then on, with the state intact
:class:`DonationHazard`          a graph step writes its static state buffers, then dies while the state is in
                                 flight: the metric must reset to its defaults with the "failed mid-flight"
                                 warning; the harness restores the last snapshot and replays
:class:`CollectiveTimeout`       a gather hangs or raises for its first N attempts: the bounded sync must retry
                                 with backoff, then succeed or degrade
:class:`NaNPoison`               seeded batch elements become NaN/Inf: ``nan_policy`` must count (and under
                                 ``"mask"`` neutralise) every one inside the update
preemption                       :meth:`ChaosRunner.run` drops the metric between steps and restores a fresh
                                 one from its snapshot blob
:class:`StagingTransferFailure`  ``serve.staging.device_put`` raises for the first N transfers: the pipeline
                                 must hand the host batch through, count ``serve.staging_fallbacks`` and warn
                                 once; values bit-identical
:class:`DrainThreadDeath`        ``IngestEngine._apply_window`` raises :class:`DrainKilled` once: the drain
                                 hands its window back and dies; the restart latch must re-apply it FIFO
:class:`QueueOverflow`           the drain is held, so every enqueue past ``max_inflight`` meets the configured
                                 ``on_full`` policy deterministically
:class:`PreemptMidOverlap`       the engine is abandoned cold with batches in its window: only the write-ahead
                                 journal survives, and ``snapshot + replay`` recovers
===============================  ===========================================================================

The port has no ahead-of-time compiler and donates no buffer. Its counterparts of the JAX package's AOT
executables are captured CUDA graphs (``ops/dispatch.py``): :class:`AotCompileFailure` fails a capture, and
:class:`DonationHazard` is a partial in-place write of the static buffers, not a donation. Both act on the graph
tier only (the card, or ``dispatch.EMULATE_ON_CPU``); an eager step has no such seam and they do not fire there.

Every firing bumps ``robust.injected_faults`` (the injectors also record a ``chaos.injected`` flight event and
capture a post-mortem bundle); every absorbed fault bumps ``robust.recovered``, so a chaos run leaves an auditable
counter trail. :class:`ChaosRunner` is the reference drive loop, :class:`SimWorld` an emulated N-rank world at the
``process_sync`` gather seam, and the ``scenario_*`` functions the composite multi-fault scenarios, each returning
the JAX package's result keys.

Not ported yet: ``ChaosMatrix``, ``scenario_sharded_preemption_restore`` and ``scenario_compressed_sync_quorum``
(ROADMAP.md, queue A, items 9b and 9c: the wire codecs and the shard), and ``scenario_schedule_race_sweep``
(item 10: it drives ``_lint.racerun``). The serve and online scenarios run their plain and keyed variants; their
sharded variant waits for the shard (item 9c).
"""
from __future__ import annotations

import os
import random
import time
import warnings
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.ops import dispatch as _dispatch
from torchmetrics_tpu_torch.utils.exceptions import SyncTimeoutError
from torchmetrics_tpu_torch.utils.prints import reset_warning_cache

#: env knob that pins the chaos seed (the injectors' tests, the bounded sync's jitter and the serving tier's
#: park read it)
ENV_CHAOS_SEED = "TM_TPU_CHAOS_SEED"
DEFAULT_SEED = 1234


def counters() -> Dict[str, int]:
    """Current chaos/robustness counter values, under the JAX package's names."""
    names = (
        "robust.injected_faults",
        "robust.recovered",
        "robust.degraded_syncs",
        "robust.sync_retries",
        "robust.snapshots",
        "robust.restores",
        "robust.journal_appends",
        "robust.journal_replays",
        "robust.reconciliations",
        "sync.quorum_syncs",
        "sync.rank_evictions",
        "sync.rank_readmissions",
    )
    return {n: obs.telemetry.counter(n).value for n in names}


@contextmanager
def _patched(obj: Any, attr: str, value: Any) -> Iterator[None]:
    original = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, original)


class Injector:
    """Base fault injector: a reusable context manager that records firings.

    ``fired`` counts how many times the fault actually triggered inside the ``with`` block; each firing
    bumps the global ``robust.injected_faults`` counter.
    """

    name = "fault"

    def __init__(self) -> None:
        self.fired = 0

    def _fire(self) -> None:
        self.fired += 1
        obs.telemetry.counter("robust.injected_faults").inc()
        # every injected fault is a flight-ring event AND a post-mortem bundle: the chaos tier exercises
        # exactly the failure seams production bundles come from
        obs.flightrec.record("chaos.injected", injector=self.name, firing=self.fired)
        obs.capture_bundle(f"chaos.{self.name}")

    def __enter__(self) -> "Injector":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


class AotCompileFailure(Injector):
    """Make the graph captures of metric steps raise ``CaptureError`` while armed (the JAX package's forced AOT
    compile failure, ``chaos.py:124``).

    Steady-state steps replay graphs already captured and never reach the capture, so the injector also drops
    the cached graph of each metric step it sees: the step goes down the capture path, where the injected
    failure fires, and :meth:`~torchmetrics_tpu_torch.ops.dispatch.GraphCache.run` must latch the key broken and
    run the step eagerly with the state intact. Other owners' graphs (the time series' fold) are left alone.
    """

    name = "aot_compile_failure"

    def __enter__(self) -> "AotCompileFailure":
        real_run = _dispatch.GraphCache.run

        def boom(*args: Any, **kwargs: Any) -> Any:
            self._fire()
            raise _dispatch.CaptureError("chaos: injected graph capture failure")

        def forced(cache: Any, owner: Any, op: str, key: Any, *rest: Any) -> Any:
            if not hasattr(owner, "_state"):
                return real_run(cache, owner, op, key, *rest)
            cache.steps.pop(key, None)
            with _patched(_dispatch, "capture", boom):
                return real_run(cache, owner, op, key, *rest)

        self._cm = _patched(_dispatch.GraphCache, "run", forced)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc: Any) -> bool:
        return self._cm.__exit__(*exc)


class DonationHazard(Injector):
    """Kill a metric's graph step after it wrote its static state buffers (``chaos.py:155``).

    The JAX package deletes the donated state buffers and raises, so its engine sees dead buffers. The port
    donates nothing; its hazard is a partial in-place write: the replay runs (the graph writes the static
    buffers), then the step raises while ``StateStore.inflight`` is set. The metric must reset to its defaults
    with the explicit "failed mid-flight" warning (``Metric._recover_failed_step``), and :class:`ChaosRunner`
    restores the last snapshot and replays the step.
    """

    name = "donation_hazard"

    def __enter__(self) -> "DonationHazard":
        real_run = _dispatch.GraphCache.run
        real_replay = _dispatch.StepGraph.replay

        def sabotage(step: Any) -> None:
            real_replay(step)  # the static state buffers now hold the step's writes
            self._fire()
            raise RuntimeError("chaos: injected mid-flight graph step failure")

        def hazardous(cache: Any, owner: Any, *rest: Any) -> Any:
            if not hasattr(owner, "_state"):
                return real_run(cache, owner, *rest)
            with _patched(_dispatch.StepGraph, "replay", sabotage):
                return real_run(cache, owner, *rest)

        self._cm = _patched(_dispatch.GraphCache, "run", hazardous)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc: Any) -> bool:
        return self._cm.__exit__(*exc)


class CollectiveTimeout:
    """A ``dist_sync_fn`` whose first ``fail_attempts`` gather calls hang (or raise) (``chaos.py:182``).

    Drives the bounded sync's deadline, retries and degraded mode end to end. Not a patcher: pass the instance
    as ``dist_sync_fn=...`` (or ``gather_fn``). ``hang_s=None`` raises a ``TimeoutError`` at once instead of
    sleeping, faster for retry-path tests.
    """

    def __init__(self, fail_attempts: int = 1, hang_s: Optional[float] = 0.25) -> None:
        self.fail_attempts = fail_attempts
        self.hang_s = hang_s
        self.calls = 0
        self.fired = 0

    def __call__(self, value: Any, group: Any = None, **kwargs: Any) -> List[Any]:
        self.calls += 1
        if self.fired < self.fail_attempts:
            self.fired += 1
            obs.telemetry.counter("robust.injected_faults").inc()
            if self.hang_s is not None:
                time.sleep(self.hang_s)  # outlive the caller's deadline: a straggler peer
                raise TimeoutError("chaos: straggler gather outlived its deadline")
            raise TimeoutError("chaos: injected collective timeout")
        return [value]  # a healthy world-of-one gather


class NaNPoison:
    """Seeded NaN/Inf poisoning of a batch stream (``chaos.py:208``).

    ``poison(batches)`` returns ``(poisoned, zeroed)``: ``poisoned`` has a seeded subset of float elements
    replaced by NaN (or +-Inf), and ``zeroed`` is the *reference* stream with those elements replaced by ``0.0``,
    what ``nan_policy="mask"`` must reduce the poisoned stream to, so that a bit-identical comparison means
    something. Batches come back as numpy arrays (tensors are read to the host first); the draws are the JAX
    package's, so one seed poisons the same elements in both packages.
    """

    def __init__(self, seed: int, rate: float = 0.1,
                 values: Sequence[float] = (float("nan"), float("inf"), float("-inf"))) -> None:
        self.rng = random.Random(seed)
        self.rate = rate
        self.values = tuple(values)
        self.poisoned_elements = 0

    def _poison_array(self, arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        flat = np.array(arr, dtype=np.float32).reshape(-1)
        zeroed = flat.copy()
        for i in range(flat.size):
            if self.rng.random() < self.rate:
                flat[i] = self.rng.choice(self.values)
                zeroed[i] = 0.0
                self.poisoned_elements += 1
                obs.telemetry.counter("robust.injected_faults").inc()
        return flat.reshape(arr.shape), zeroed.reshape(arr.shape)

    def poison(self, batches: Sequence[Tuple[Any, ...]]) -> Tuple[List[Tuple[Any, ...]], List[Tuple[Any, ...]]]:
        poisoned: List[Tuple[Any, ...]] = []
        zeroed: List[Tuple[Any, ...]] = []
        for batch in batches:
            p_parts, z_parts = [], []
            for part in batch:
                arr = _np(part)
                if np.issubdtype(arr.dtype, np.floating):
                    p, z = self._poison_array(arr)
                else:
                    p = z = arr
                p_parts.append(p)
                z_parts.append(z)
            poisoned.append(tuple(p_parts))
            zeroed.append(tuple(z_parts))
        return poisoned, zeroed


class StagingTransferFailure(Injector):
    """Make the serving tier's host-to-device staging transfer raise.

    Patches the ``device_put`` seam in ``torchmetrics_tpu_torch.serve.staging`` for the first ``fail_calls``
    transfers. The :class:`~torchmetrics_tpu_torch.serve.staging.StagingPipeline` must absorb the failure
    (fall back to unstaged host batches, count ``serve.staging_fallbacks``, warn once) and values must be
    bit-identical with the staged run (staging is placement-only).
    """

    name = "staging_transfer_failure"

    def __init__(self, fail_calls: int = 1) -> None:
        super().__init__()
        self.fail_calls = fail_calls

    def __enter__(self) -> "StagingTransferFailure":
        from torchmetrics_tpu_torch.serve import staging as _staging

        real = _staging.device_put

        def flaky(x: Any, *args: Any, **kwargs: Any) -> Any:
            if self.fired < self.fail_calls:
                self._fire()
                raise RuntimeError("chaos: injected staging transfer failure")
            return real(x, *args, **kwargs)

        self._cm = _patched(_staging, "device_put", flaky)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc: Any) -> bool:
        return self._cm.__exit__(*exc)


class DrainThreadDeath(Injector):
    """Kill the async ingestion drain thread between dequeue and apply.

    Patches ``IngestEngine._apply_window`` to raise :class:`~torchmetrics_tpu_torch.serve.engine.DrainKilled`
    (which the apply-failure handler cannot catch) ``kills`` times: the drain hands its in-flight window
    back to the queue head and the thread terminates, exactly an external kill. The engine's restart latch
    (driven by the next quiesce/enqueue) must revive the drain and re-apply the window FIFO,
    bit-identically: no batch applied twice, none lost.
    """

    name = "drain_thread_death"

    def __init__(self, kills: int = 1) -> None:
        super().__init__()
        self.kills = kills

    def __enter__(self) -> "DrainThreadDeath":
        from torchmetrics_tpu_torch.serve import engine as _engine

        real = _engine.IngestEngine._apply_window

        def lethal(engine: Any, items: list) -> None:
            if self.fired < self.kills:
                self._fire()
                raise _engine.DrainKilled("chaos: injected drain-thread death")
            return real(engine, items)

        self._cm = _patched(_engine.IngestEngine, "_apply_window", lethal)
        self._cm.__enter__()
        return self

    def __exit__(self, *exc: Any) -> bool:
        return self._cm.__exit__(*exc)


class QueueOverflow(Injector):
    """Deterministically overflow an ingestion window by holding its drain.

    ``with QueueOverflow(engine):`` pauses the drain so every enqueue past ``max_inflight`` hits the
    configured ``on_full`` policy (block/raise/shed) with no thread-timing luck involved; the drain resumes
    on exit. The window bound itself is the recovery property under test: backpressure, never unbounded
    growth.
    """

    name = "queue_overflow"

    def __init__(self, engine: Any) -> None:
        super().__init__()
        self.engine = engine

    def __enter__(self) -> "QueueOverflow":
        self._fire()
        self.engine.pause()
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.engine.resume()
        return False


class PreemptMidOverlap(Injector):
    """Preempt a serving metric with batches still in its ingestion window.

    :meth:`strike` abandons the engine cold (window dropped, drain stopped), modelling a preemption that
    lands while transfer overlaps compute. The write-ahead journal (appended at ENQUEUE time) is the only
    survivor; recovery is ``snapshot + replay(journal)`` on a fresh metric, bit-identical with the
    never-preempted run.
    """

    name = "preempt_mid_overlap"

    def __init__(self) -> None:
        super().__init__()
        self.dropped_in_window = 0

    def strike(self, metric: Any) -> int:
        """Kill the metric's engine mid-window; returns the batch count dropped."""
        engine = metric.__dict__.get("_serve")
        if engine is None:
            raise ValueError("PreemptMidOverlap.strike needs a metric with a live serve engine")
        self._fire()
        self.dropped_in_window = engine.abandon()
        return self.dropped_in_window


class ChaosRunner:
    """Drive a metric through a batch stream with faults, snapshots and replay recovery (``chaos.py:374``).

    Checkpoint-based crash recovery in miniature: snapshot after every committed step; when a step faults (an
    exception escapes, or the engine's "failed mid-flight" reset warning fires, the state silently back at its
    defaults) build a fresh instance with ``factory`` (the preemption model: the old process is gone), restore
    the last snapshot, and replay the step without the fault. ``via="update"`` drives ``update`` instead of
    ``forward``.
    """

    def __init__(self, factory: Callable[[], Any], seed: Optional[int] = None) -> None:
        self.factory = factory
        self.seed = DEFAULT_SEED if seed is None else seed
        self.rng = random.Random(self.seed)
        self.faults_seen = 0
        self.replays = 0

    def pick_fault_step(self, n_batches: int) -> int:
        """Seeded choice of the step to fault at (never step 0: the first capture must already exist for the
        latches to matter)."""
        return self.rng.randrange(1, max(2, n_batches))

    def _step(self, metric: Any, batch: Tuple[Any, ...], via: str) -> None:
        _step(metric, batch, via)

    def run(
        self,
        batches: Sequence[Tuple[Any, ...]],
        injector: Optional[Injector] = None,
        fault_steps: Sequence[int] = (),
        preempt_steps: Sequence[int] = (),
        via: str = "forward",
    ) -> Any:
        """Run the stream; returns the final metric instance (ready to compute)."""
        metric = self.factory()
        snap = metric.snapshot()
        fault_at = set(fault_steps)
        preempt_at = set(preempt_steps)
        for i, batch in enumerate(batches):
            armed = injector is not None and i in fault_at
            faulted = False
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                reset_warning_cache()
                try:
                    if armed:
                        with injector:
                            self._step(metric, batch, via)
                    else:
                        self._step(metric, batch, via)
                except Exception as err:
                    obs.flightrec.record("chaos.fault_detected", error=repr(err)[:200])
                    faulted = True
                if any("failed mid-flight" in str(w.message) for w in caught):
                    # the engine absorbed a mid-flight step death by resetting the state to its defaults: usable
                    # but wrong against the stream, so replay
                    faulted = True
            if faulted:
                self.faults_seen += 1
                metric = self.factory()
                metric.restore(snap)
                self._step(metric, batch, via)  # replay without the fault
                self.replays += 1
                obs.telemetry.counter("robust.recovered").inc()
            elif armed and getattr(injector, "fired", 0):
                # the fault fired and the engine recovered by itself (a broken capture latched eager)
                obs.telemetry.counter("robust.recovered").inc()
            if i in preempt_at:
                # preemption between update and compute: only the blob survives the process
                blob = metric.snapshot()
                metric = self.factory()
                metric.restore(blob)
            snap = metric.snapshot()
        return metric


# ---------------------------------------------------------------------------
# Composite multi-fault scenarios
# ---------------------------------------------------------------------------

def _np(x: Any) -> np.ndarray:
    """A value as a host numpy array (a tensor through ``.detach().cpu()``)."""
    if isinstance(x, Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _bytes(t: Tensor) -> bytes:
    """A tensor's bytes on the host, whatever its dtype."""
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _same_tensor(a: Tensor, b: Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and _bytes(a) == _bytes(b)


class SimWorld:
    """An emulated N-rank eager world at the ``process_sync`` gather seam (``chaos.py:459``).

    Rank 0 is the calling process (its payload arrives as ``value``); every other rank's contribution is read
    live from its metric instance's ``StateStore``, so the emulated world stays consistent as the instances
    accumulate. Ranks in ``down`` miss the gather: the call raises :class:`SyncTimeoutError` carrying the
    partial per-rank ``responses``, the quorum seam a partial-capable collective exposes. The ``ranks`` subgroup
    keyword is honoured (one entry per requested rank, in order), so the health ledger's evictions really shrink
    the gather group and its probes really put the evicted rank back. Payloads travel raw: a ``compression``
    other than ``"none"`` raises until the codecs are ported (ROADMAP.md, queue A, item 9b).
    """

    def __init__(self, metrics: Sequence[Any], compression: str = "none") -> None:
        if compression != "none":
            raise NotImplementedError(
                f"SimWorld(compression={compression!r}): compressed sync is not ported yet (ROADMAP.md, queue A,"
                " item 9b)"
            )
        self.metrics: List[Any] = list(metrics)
        self.down: set = set()
        self.calls = 0
        self.timeouts = 0
        self.last_ranks: Optional[Tuple[int, ...]] = None
        self.compression = compression

    def options(self, **kw: Any) -> Any:
        """``SyncOptions`` pinned to this world's size (pass the quorum, evict and probe knobs)."""
        from torchmetrics_tpu_torch.parallel.sync import SyncOptions

        return SyncOptions(world=len(self.metrics), **kw)

    def state_value(self, rank: int, name: str) -> Any:
        m = self.metrics[rank]
        st = m._state
        if name in st.lists:
            entries = st.lists[name]
            if not entries:
                return torch.empty((0,), dtype=torch.float32, device=m.device)
            return torch.cat([torch.atleast_1d(e) for e in entries], dim=0)
        return st.tensors[name]

    def __call__(self, value: Any, group: Any = None, *, name: Optional[str] = None,
                 ranks: Optional[Sequence[int]] = None) -> List[Any]:
        self.calls += 1
        requested = tuple(ranks) if ranks is not None else tuple(range(len(self.metrics)))
        self.last_ranks = requested
        responses: Dict[int, Any] = {}
        for r in requested:
            if r == 0:
                responses[r] = value
            elif r not in self.down:
                responses[r] = self.state_value(r, name)
        if len(responses) < len(requested):
            self.timeouts += 1
            obs.telemetry.counter("robust.injected_faults").inc()
            missing = sorted(set(requested) - set(responses))
            raise SyncTimeoutError(f"chaos: rank(s) {missing} down mid-gather", responses=responses)
        return [responses[r] for r in requested]


def _seeded_batches(rng: random.Random, n: int, size: int = 4) -> List[Tuple[Any, ...]]:
    """Integer-valued float batches: float reductions stay exact, so bit-identical means bit-identical rather
    than within epsilon."""
    return [
        (np.asarray([float(rng.randint(0, 9)) for _ in range(size)], np.float32),)
        for _ in range(n)
    ]


def _states_identical(a: Any, b: Any) -> bool:
    """Byte-for-byte equality of two metrics' full state stores (tensors and lists)."""
    ta, tb = a._state.tensors, b._state.tensors
    if set(ta) != set(tb) or set(a._state.lists) != set(b._state.lists):
        return False
    if not all(_same_tensor(ta[n], tb[n]) for n in ta):
        return False
    for n in a._state.lists:
        ea, eb = a._state.lists[n], b._state.lists[n]
        if len(ea) != len(eb) or not all(_same_tensor(x, y) for x, y in zip(ea, eb)):
            return False
    return True


def _bundle_cursor_replay(make: Callable[[], Any], jdir: str, recovered: Any) -> Optional[bool]:
    """Post-mortem twin recovery: replay from the last captured bundle's journal cursor (``chaos.py:565``).

    The preemption strike captured a bundle whose journal section pins the cursor at the abandoned instant;
    recovering a fresh instance through that cursor must land on byte-identical state with the ordinary
    ``recover``. None when no bundle was captured (bundling disabled), else True or False.
    """
    bundle_path = obs.last_bundle_path()
    if bundle_path is None:
        return None
    from torchmetrics_tpu_torch.robust import journal as _journal

    twin = make()
    _journal.recover(twin, jdir, cursor=bundle_path)
    return _states_identical(twin, recovered)


def _identical(a: Any, b: Any) -> bool:
    a, b = _np(a), _np(b)
    return a.shape == b.shape and bool(np.array_equal(a, b, equal_nan=True))


def _arm_sync(metric: Any, world: SimWorld, opts: Any) -> None:
    metric.dist_sync_fn = world
    metric.distributed_available_fn = lambda: True
    metric.sync_options = opts


def _step(metric: Any, batch: Tuple[Any, ...], via: str) -> None:
    if via == "forward":
        metric(*batch)
    else:
        metric.update(*batch)


def scenario_rank_death_quorum_rejoin(
    factory: Callable[[], Any], rng: random.Random, n_batches: int, via: str, workdir: str
) -> Dict[str, Any]:
    """Rank death mid-gather, quorum sync, journal recovery, reconciliation, rejoin (``chaos.py:602``).

    A 2-rank emulated world accumulates disjoint shards; rank 1 journals every batch. At a seeded step rank 1
    dies mid-gather: rank 0's ``compute()`` must degrade to a QUORUM sync (not local, not a hang). Rank 1 then
    restarts: a fresh instance restores ``snapshot + replay(journal)``, the quorum side ships a reconciliation
    offer (its merged view), which the warm rejoiner verifies, and the world heals. The final full-world
    ``compute()`` must be bit-identical with a never-faulted reference world.
    """
    from torchmetrics_tpu_torch.robust import checkpoint as _checkpoint
    from torchmetrics_tpu_torch.robust import journal as _journal

    n_batches = max(3, n_batches)
    shards = [_seeded_batches(rng, n_batches), _seeded_batches(rng, n_batches)]
    m0, m1 = factory(), factory()
    world = SimWorld([m0, m1])
    # evict_after=99: this scenario exercises quorum and rejoin, not the circuit breaker
    _arm_sync(m0, world, world.options(quorum=1, evict_after=99))
    jpath = f"{workdir}/rank1-wal"
    jm1 = m1.journal(jpath, every_k=2)
    death = rng.randrange(1, n_batches - 1)
    quorum_level = recovery = None
    for i in range(n_batches):
        _step(m0, shards[0][i], via)
        jm1.update(*shards[1][i])
        if i == death:
            world.down.add(1)  # rank 1 dies mid-epoch; the next gather sees it missing
            m0.compute()
            quorum_level = str(m0.world_consistent)
            # rank 1's process is gone: a fresh instance restores snapshot + journal replay
            m1 = factory()
            recovery = _journal.recover(m1, jpath)
            jm1 = m1.journal(jpath, every_k=2)
            # re-admission handshake: the quorum side ships its merged view; the warm rejoiner checks that it
            # is structurally compatible without overwriting its state
            with m0.sync_context():
                offer = _checkpoint.reconciliation_offer(m0, responding_ranks=(0,), epoch=i)
            _checkpoint.accept_reconciliation(m1, offer, mode="verify")
            world.metrics[1] = m1
            world.down.discard(1)
            obs.telemetry.counter("robust.recovered").inc()
    final = m0.compute()
    final_level = str(m0.world_consistent)
    # the reference: the same shard streams through a never-faulted world
    r0, r1 = factory(), factory()
    ref_world = SimWorld([r0, r1])
    _arm_sync(r0, ref_world, ref_world.options())
    for i in range(n_batches):
        _step(r0, shards[0][i], via)
        r1.update(*shards[1][i])
    expected = r0.compute()
    bit_identical = _identical(final, expected)
    return {
        "passed": bit_identical and quorum_level == "quorum" and final_level == "full",
        "bit_identical": bit_identical,
        "quorum_level": quorum_level,
        "final_level": final_level,
        "death_step": death,
        "journal_recovery": {k: v for k, v in (recovery or {}).items()},
    }


def scenario_preemption_journal_replay(
    factory: Callable[[], Any], rng: random.Random, n_batches: int, via: str, workdir: str
) -> Dict[str, Any]:
    """Preemption mid-epoch (mid-buffered-window too), then ``snapshot + replay(journal)`` (``chaos.py:668``).

    A journaled metric is driven partway through a seeded stream and then dropped cold; with
    ``via="buffered"`` batches are still pending in the buffered window, which the state never saw and only the
    write-ahead journal did. A fresh instance recovers from the journal directory, finishes the stream, and
    must be bit-identical with an uninterrupted reference run.
    """
    from torchmetrics_tpu_torch.robust import journal as _journal

    n_batches = max(3, n_batches)
    batches = _seeded_batches(rng, n_batches)
    jdir = f"{workdir}/wal"
    m = factory()
    jm = m.journal(jdir, every_k=3)
    preempt = rng.randrange(1, n_batches - 1)
    pending_at_death = 0
    if via == "buffered":
        buf = jm.buffered(2)
        for i in range(preempt + 1):
            buf.update(*batches[i])
        pending_at_death = buf.pending  # window batches the state never saw
    else:
        for i in range(preempt + 1):
            (jm.forward if via == "forward" else jm.update)(*batches[i])
    # the process dies here: no flush, no clean exit, the instance is garbage
    obs.telemetry.counter("robust.injected_faults").inc()
    fresh = factory()
    recovery = _journal.recover(fresh, jdir)
    obs.telemetry.counter("robust.recovered").inc()
    for b in batches[preempt + 1:]:
        fresh.update(*b)
    ref = factory()
    for b in batches:
        ref.update(*b)
    bit_identical = _identical(fresh.compute(), ref.compute())
    return {
        "passed": bit_identical,
        "bit_identical": bit_identical,
        "preempt_step": preempt,
        "pending_at_death": pending_at_death,
        "replayed": recovery["replayed"],
        "snapshot_restored": recovery["snapshot_restored"],
    }


def scenario_keyed_preemption_journal(
    factory: Callable[[], Any], rng: random.Random, n_batches: int, via: str, workdir: str
) -> Dict[str, Any]:
    """Keyed twin of the preemption scenario: a multi-tenant table dies mid-epoch (``chaos.py:717``).

    A ``KeyedMetric(template, N)`` journals a seeded mixed-tenant stream and is dropped cold at a seeded step.
    A fresh keyed instance recovers ``snapshot + replay(journal)``, finishes the stream, and all ``N`` key states
    must be bit-identical with an uninterrupted keyed run and with a per-key instance-dict reference (the loop
    the keyed engine replaces). Templates that cannot be keyed (list states) report a skipped cell that passes.
    """
    del via  # the keyed protocol is update-only (no per-batch forward value)
    from torchmetrics_tpu_torch.keyed import KeyedMetric
    from torchmetrics_tpu_torch.robust import journal as _journal
    from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

    try:
        probe = KeyedMetric(factory(), 2)
    except TorchMetricsUserError as err:
        return {"passed": True, "skipped": str(err), "scenario_applicable": False}
    del probe
    n_keys = 6
    n_batches = max(3, n_batches)
    batches = []
    for _ in range(n_batches):
        ids = np.asarray([rng.randrange(n_keys) for _ in range(5)], np.int32)
        vals = np.asarray([float(rng.randint(0, 9)) for _ in range(5)], np.float32)
        batches.append((ids, vals))
    jdir = f"{workdir}/keyed-wal"
    m = KeyedMetric(factory(), n_keys)
    jm = m.journal(jdir, every_k=3)
    preempt = rng.randrange(1, n_batches - 1)
    for i in range(preempt + 1):
        jm.update(*batches[i])
    # the process dies here: no flush, no clean exit, the instance is garbage
    obs.telemetry.counter("robust.injected_faults").inc()
    fresh = KeyedMetric(factory(), n_keys)
    recovery = _journal.recover(fresh, jdir)
    obs.telemetry.counter("robust.recovered").inc()
    for b in batches[preempt + 1:]:
        fresh.update(*b)
    ref = KeyedMetric(factory(), n_keys)
    for b in batches:
        ref.update(*b)
    bit_identical = _identical(fresh.compute(), ref.compute())
    # cross-check against the per-instance loop the keyed engine replaces
    insts = [factory() for _ in range(n_keys)]
    for ids, vals in batches:
        for k in range(n_keys):
            if np.any(ids == k):
                insts[k].update(vals[ids == k])
    loop_vals = np.stack([_np(insts[k].compute()) for k in range(n_keys)])
    loop_identical = _identical(fresh.compute(), loop_vals)
    return {
        "passed": bool(bit_identical and loop_identical),
        "bit_identical": bit_identical,
        "instance_loop_identical": loop_identical,
        "preempt_step": preempt,
        "num_keys": n_keys,
        "replayed": recovery["replayed"],
        "snapshot_restored": recovery["snapshot_restored"],
    }


def scenario_sketch_preemption_journal(
    factory: Callable[[], Any], rng: random.Random, n_batches: int, via: str, workdir: str
) -> Dict[str, Any]:
    """Sketch twin of the preemption scenario: O(1) sketch states die mid-epoch (``chaos.py:783``).

    A ``StreamingQuantile`` (KLL compactor, a callable-merge state) and a sketch-mode ``BinaryAUROC`` (a
    sum-merged histogram pair) journal a seeded stream and are dropped cold at a seeded step. Fresh instances
    recover ``snapshot + replay(journal)``, finish the stream, and must be bit-identical with uninterrupted
    runs: replay re-drives the same merges in the same order. The scenario pins its own sketch metrics, on the
    device of the factory's metrics.
    """
    del via  # sketch recovery is update-driven; the metrics are pinned here
    from torchmetrics_tpu_torch.classification import BinaryAUROC
    from torchmetrics_tpu_torch.robust import journal as _journal
    from torchmetrics_tpu_torch.sketch import StreamingQuantile

    device = factory().device
    n_batches = max(3, n_batches)
    q_batches = [
        np.asarray([rng.uniform(0.0, 100.0) for _ in range(64)], np.float32)
        for _ in range(n_batches)
    ]
    a_batches = []
    for _ in range(n_batches):
        preds = np.asarray([rng.random() for _ in range(32)], np.float32)
        target = np.asarray([1 if rng.random() < p else 0 for p in preds], np.int32)
        a_batches.append((preds, target))
    make_q = lambda: StreamingQuantile(q=0.5, capacity=32, levels=12, device=device)  # noqa: E731
    make_a = lambda: BinaryAUROC(approx="sketch", sketch_bins=64, device=device)  # noqa: E731
    preempt = rng.randrange(1, n_batches - 1)
    jq = make_q().journal(f"{workdir}/sketch-q-wal", every_k=3)
    ja = make_a().journal(f"{workdir}/sketch-a-wal", every_k=3)
    for i in range(preempt + 1):
        jq.update(q_batches[i])
        ja.update(*a_batches[i])
    # the process dies here: no flush, no clean exit, the instances are garbage
    obs.telemetry.counter("robust.injected_faults").inc()
    fresh_q, fresh_a = make_q(), make_a()
    rec_q = _journal.recover(fresh_q, f"{workdir}/sketch-q-wal")
    rec_a = _journal.recover(fresh_a, f"{workdir}/sketch-a-wal")
    obs.telemetry.counter("robust.recovered").inc()
    for i in range(preempt + 1, n_batches):
        fresh_q.update(q_batches[i])
        fresh_a.update(*a_batches[i])
    ref_q, ref_a = make_q(), make_a()
    for i in range(n_batches):
        ref_q.update(q_batches[i])
        ref_a.update(*a_batches[i])
    quantile_identical = _identical(fresh_q.compute(), ref_q.compute())
    auroc_identical = _identical(fresh_a.compute(), ref_a.compute())
    # the recovered STATE must be bit-identical too, not just the finalised value
    state_identical = all(_same_tensor(fresh_q._state.tensors[n], ref_q._state.tensors[n])
                          for n in fresh_q._state.tensors)
    return {
        "passed": bool(quantile_identical and auroc_identical and state_identical),
        "quantile_identical": quantile_identical,
        "auroc_identical": auroc_identical,
        "sketch_state_identical": state_identical,
        "preempt_step": preempt,
        "replayed": rec_q["replayed"] + rec_a["replayed"],
        "snapshot_restored": bool(rec_q["snapshot_restored"] or rec_a["snapshot_restored"]),
    }


def scenario_flap_evict_readmit(
    factory: Callable[[], Any], rng: random.Random, n_batches: int, via: str, workdir: str,
    probe_backoff_s: float = 0.2,
) -> Dict[str, Any]:
    """Flapping rank, circuit-breaker eviction, backoff probe, re-admission (``chaos.py:913``).

    Rank 1 times out on consecutive syncs until the health ledger trips its breaker (``evict_after=2``); the
    next sync must run over the shrunk gather group (rank 1 left out: no more stalling) at quorum grade. After
    the rank heals and the probe backoff (``probe_backoff_s``, JAX's 0.2 s by default) has passed, the next sync
    puts it back, re-admits it, and grades ``full``, with a final value bit-identical to a never-faulted world.
    """
    del workdir
    from torchmetrics_tpu_torch.parallel.sync import health_ledger

    shards = [_seeded_batches(rng, 4), _seeded_batches(rng, 4)]
    m0, m1 = factory(), factory()
    world = SimWorld([m0, m1])
    opts = world.options(quorum=1, evict_after=2, probe_backoff_s=probe_backoff_s)
    _arm_sync(m0, world, opts)
    ev0 = obs.telemetry.counter("sync.rank_evictions").value
    re0 = obs.telemetry.counter("sync.rank_readmissions").value
    # phase 1: two flapping syncs; rank 1 misses both, tripping the breaker
    world.down.add(1)
    for i in (0, 1):
        _step(m0, shards[0][i], via)
        m1.update(*shards[1][i])
        m0.compute()
    evicted = health_ledger().evicted_ranks()
    # phase 2: the circuit is open and rank 1 still down, but the gather group leaves it out, so the sync
    # succeeds over the subgroup instead of stalling through the timeout machinery
    _step(m0, shards[0][2], via)
    m1.update(*shards[1][2])
    m0.compute()
    level_open = str(m0.world_consistent)
    ranks_open = world.last_ranks
    # phase 3: the rank heals; once the probe backoff has passed the sync puts it back
    world.down.discard(1)
    time.sleep(opts.probe_backoff_s * 1.5)
    _step(m0, shards[0][3], via)
    m1.update(*shards[1][3])
    final = m0.compute()
    final_level = str(m0.world_consistent)
    # the reference: the same four batches per shard through a healthy world
    r0, r1 = factory(), factory()
    ref_world = SimWorld([r0, r1])
    _arm_sync(r0, ref_world, ref_world.options())
    for i in range(4):
        _step(r0, shards[0][i], via)
        r1.update(*shards[1][i])
    expected = r0.compute()
    bit_identical = _identical(final, expected)
    evictions = obs.telemetry.counter("sync.rank_evictions").value - ev0
    readmissions = obs.telemetry.counter("sync.rank_readmissions").value - re0
    return {
        "passed": bool(
            bit_identical and evicted == (1,) and evictions >= 1 and readmissions >= 1
            and level_open == "quorum" and final_level == "full"
        ),
        "bit_identical": bit_identical,
        "evicted_ranks": evicted,
        "evictions": evictions,
        "readmissions": readmissions,
        "level_while_open": level_open,
        "gather_ranks_while_open": ranks_open,
        "final_level": final_level,
    }


# ---------------------------------------------------------------------------
# Serving-tier scenarios: preemption mid-overlap, drain death, overflow, oscillating load
# ---------------------------------------------------------------------------

def _serve_variants(
    factory: Callable[[], Any], rng: random.Random, n_batches: int
) -> List[Tuple[str, Callable[[], Any], List[Tuple[Any, ...]]]]:
    """(name, make_metric, batches) triples over plain and keyed metrics (``chaos.py:1162``).

    Each variant's reference is the same maker driven synchronously, so every cell proves async-against-sync
    bit-identity within its own tier. Templates that cannot be keyed (list states) leave out the keyed variant.
    The JAX package's sharded variant waits for the shard (ROADMAP.md, queue A, item 9c); the rng draws its
    batches all the same, so the later draws stay the JAX package's.
    """
    from torchmetrics_tpu_torch.keyed import KeyedMetric
    from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

    out: List[Tuple[str, Callable[[], Any], List[Tuple[Any, ...]]]] = [
        ("plain", factory, _seeded_batches(rng, n_batches)),
    ]
    try:
        KeyedMetric(factory(), 2)
        keyable = True
    except TorchMetricsUserError:
        keyable = False
    if keyable:
        n_keys = 4
        keyed_batches = []
        for _ in range(n_batches):
            ids = np.asarray([rng.randrange(n_keys) for _ in range(5)], np.int32)
            vals = np.asarray([float(rng.randint(0, 9)) for _ in range(5)], np.float32)
            keyed_batches.append((ids, vals))
        out.append(("keyed", lambda: KeyedMetric(factory(), n_keys), keyed_batches))
    _seeded_batches(rng, n_batches)  # the sharded variant's batches (item 9c)
    return out


def scenario_serve_preempt_mid_overlap(
    factory: Callable[[], Any], rng: random.Random, n_batches: int, via: str, workdir: str
) -> Dict[str, Any]:
    """Preemption with batches still in the ingestion window, then journal replay (``chaos.py:1197``).

    A serving metric (plain and keyed variants) journals at enqueue time; part of the stream commits, the drain
    is held, more batches enter the window, and :class:`PreemptMidOverlap` drops the engine cold: the state
    never saw the window batches, only the write-ahead journal did. A fresh instance recovers
    ``snapshot + replay(journal)``, finishes the stream synchronously, and must be bit-identical with an
    uninterrupted synchronous run. The plain variant also runs with per-ticket tracing on and holds the trace
    well-formed through the preemption: every committed ticket's enqueue flow resolves onto the drain thread's
    track, and the window batches the preemption dropped close their flows as ``serve.stage.abandoned``.
    """
    del via  # the async protocol is update-shaped; tickets have no per-batch value
    from torchmetrics_tpu_torch.obs import trace as _obs_trace
    from torchmetrics_tpu_torch.robust import journal as _journal
    from torchmetrics_tpu_torch.serve import ServeOptions

    n_batches = max(4, n_batches)
    preempt = rng.randrange(1, n_batches - 1)
    variants = _serve_variants(factory, rng, n_batches)
    detail: Dict[str, Any] = {"preempt_step": preempt}
    passed = True
    for name, make, batches in variants:
        jdir = f"{workdir}/serve-preempt-{name}"
        traced = name == "plain"
        if traced:
            _obs_trace.clear()
        prev_enabled = obs.telemetry.enabled
        obs.telemetry.enabled = prev_enabled or traced
        try:
            m = make()
            eng = m.serve(ServeOptions(max_inflight=64), journal=_journal.Journal(jdir))
            split = max(1, (preempt + 1) // 2)
            for i in range(split):
                m.update_async(*batches[i])
            eng.quiesce()  # the prefix is committed state
            eng.pause()  # hold the drain: the rest of the prefix stays IN the window
            for i in range(split, preempt + 1):
                m.update_async(*batches[i])
            inj = PreemptMidOverlap()
            dropped = inj.strike(m)  # the process dies here; the WAL is the only survivor
        finally:
            obs.telemetry.enabled = prev_enabled
        if traced:
            trace_events = _obs_trace.events()
            verdict = _obs_trace.validate_flows(trace_events)
            abandoned = sum(1 for e in trace_events if e.get("name") == "serve.stage.abandoned")
            trace_ok = bool(verdict["valid"] and verdict["committed_flows"] >= 1 and abandoned == dropped)
            detail["trace"] = {
                "well_formed": trace_ok,
                "flows": verdict["flows"],
                "committed_cross_thread": verdict["committed_cross_thread"],
                "abandoned_closed": abandoned,
            }
            passed = passed and trace_ok
            _obs_trace.clear()
        fresh = make()
        recovery = _journal.recover(fresh, jdir)
        obs.telemetry.counter("robust.recovered").inc()
        # post-mortem contract: the strike's bundle pins the journal cursor at the abandoned instant, and
        # replaying from the bundle must land byte-identically
        bundle_replay = _bundle_cursor_replay(make, jdir, fresh)
        for i in range(preempt + 1, n_batches):
            fresh.update(*batches[i])
        ref = make()
        for b in batches:
            ref.update(*b)
        ok = _identical(fresh.compute(), ref.compute())
        passed = (
            passed and ok and dropped > 0 and recovery["replayed"] == preempt + 1
            and bundle_replay is not False
        )
        detail[name] = {
            "bit_identical": ok,
            "dropped_in_window": dropped,
            "replayed": recovery["replayed"],
            "bundle_replay_identical": bundle_replay,
        }
    detail["passed"] = passed
    return detail


def scenario_serve_drain_death(
    factory: Callable[[], Any], rng: random.Random, n_batches: int, via: str, workdir: str
) -> Dict[str, Any]:
    """Drain-thread death mid-stream, restart latch, FIFO re-apply, bit-identically (``chaos.py:1291``).

    At a seeded step :class:`DrainThreadDeath` kills the drain between dequeue and apply; the engine must hand
    the in-flight ticket back to the window, restart the thread at the next quiesce, and re-apply it, none lost
    and none doubled, across the plain and keyed variants.
    """
    del via, workdir
    from torchmetrics_tpu_torch.serve import ServeOptions

    n_batches = max(3, n_batches)
    kill_at = rng.randrange(1, n_batches - 1)
    variants = _serve_variants(factory, rng, n_batches)
    detail: Dict[str, Any] = {"preempt_step": kill_at}
    passed = True
    for name, make, batches in variants:
        m = make()
        eng = m.serve(ServeOptions(max_inflight=64))
        fired = 0
        for i, b in enumerate(batches):
            if i == kill_at:
                with DrainThreadDeath() as inj:
                    m.update_async(*b)
                    eng.quiesce()  # finds the dead drain, restarts it, re-applies FIFO
                fired = inj.fired
            else:
                m.update_async(*b)
        value = m.compute()
        ref = make()
        for b in batches:
            ref.update(*b)
        ok = _identical(value, ref.compute())
        restarts = eng.stats()["drain_restarts"]
        if fired and restarts:
            obs.telemetry.counter("robust.recovered").inc()
        passed = passed and ok and fired >= 1 and restarts >= 1
        detail[name] = {"bit_identical": ok, "kills": fired, "drain_restarts": restarts}
    detail["passed"] = passed
    return detail


def scenario_serve_queue_overflow(
    factory: Callable[[], Any], rng: random.Random, n_batches: int, via: str, workdir: str
) -> Dict[str, Any]:
    """Window overflow under a held drain: shed-mode counts exact, block-mode sheds nothing
    (``chaos.py:1335``).

    With the drain paused (:class:`QueueOverflow`) and ``max_inflight=2``, every enqueue past the window must
    shed, and the shed accounting must be exact: the final value equals a reference fed only the admitted
    batches, and ``serve.shed`` moves by exactly the shed count. A block-mode twin (drain running) must shed
    nothing and match the full-stream reference. Plain and keyed variants.
    """
    del via, workdir
    from torchmetrics_tpu_torch.serve import ServeOptions

    n_batches = max(4, n_batches)
    variants = _serve_variants(factory, rng, n_batches)
    detail: Dict[str, Any] = {"preempt_step": None}
    passed = True
    for name, make, batches in variants:
        shed0 = obs.telemetry.counter("serve.shed").value
        m = make()
        eng = m.serve(ServeOptions(max_inflight=2, on_full="shed", queue_timeout_s=1.0))
        with QueueOverflow(eng):
            tickets = [m.update_async(*b) for b in batches]
        admitted = [b for t, b in zip(tickets, batches) if not t.shed]
        n_shed = sum(1 for t in tickets if t.shed)
        value = m.compute()
        ref = make()
        for b in admitted:
            ref.update(*b)
        shed_delta = obs.telemetry.counter("serve.shed").value - shed0
        ok_shed = (
            _identical(value, ref.compute())
            and n_shed == n_batches - 2
            and shed_delta == n_shed
            and eng.stats()["shed"] == n_shed
        )
        # the block-mode twin: the drain runs, so the bounded window never sheds
        mb = make()
        engb = mb.serve(ServeOptions(max_inflight=2, on_full="block", queue_timeout_s=30.0))
        for b in batches:
            mb.update_async(*b)
        refb = make()
        for b in batches:
            refb.update(*b)
        ok_block = _identical(mb.compute(), refb.compute()) and engb.stats()["shed"] == 0
        if ok_shed:
            obs.telemetry.counter("robust.recovered").inc()
        passed = passed and ok_shed and ok_block
        detail[name] = {
            "shed_exact": ok_shed,
            "shed_count": n_shed,
            "block_bit_identical": ok_block,
            "block_stalls": engb.stats()["backpressure_stalls"],
        }
    detail["passed"] = passed
    return detail


def scenario_serve_oscillating_load(
    factory: Callable[[], Any], rng: random.Random, n_batches: int, via: str, workdir: str
) -> Dict[str, Any]:
    """Seeded square-wave load under the adaptive controller: thrash-free and replayable (``chaos.py:1394``).

    A serving metric with the ``ServeController`` attached is driven through alternating calm and overload
    phases (the drain held during overload, a seeded square wave). Actuator toggles must stay under the
    per-actuator decision-rate cap, every controller transition must land a ``control.*`` flight event, the
    adaptive run must shed no more than a static ``on_full='shed'`` engine driven through the same schedule,
    and recovery must be bit-identical twice over: a fresh instance through ``adaptive_recover`` (the WAL less
    the journaled sheds), and a twin replayed from the captured bundle's journal cursor with the same skips.
    Plain and keyed variants.
    """
    del via
    from torchmetrics_tpu_torch.robust import journal as _journal
    from torchmetrics_tpu_torch.serve import ControlOptions, ServeController, ServeOptions, adaptive_recover, shed_seqs
    from torchmetrics_tpu_torch.serve.control import CONTROL_DIR_SUFFIX

    n_batches = max(24, n_batches * 4)
    period = rng.randrange(3, 7)  # the seeded square wave's half-period, in offered batches
    sopts = ServeOptions(max_inflight=4, on_full="block", queue_timeout_s=0.05, coalesce=4)
    copts = ControlOptions(
        decision_every=2, window_short=4, window_long=8, min_hold_ticks=4,
        timed_block_timeout_s=0.01,
    )
    variants = _serve_variants(factory, rng, n_batches)
    detail: Dict[str, Any] = {"period": period, "n_batches": n_batches}
    passed = True
    for name, make, batches in variants:

        def drive(metric: Any, engine: Any) -> None:
            # the phase derives from the offer count, so the adaptive engine and the static twin see the same wave
            for i, b in enumerate(batches):
                if (i // period) % 2 == 1:
                    engine.pause()  # overload phase: the drain is wedged
                else:
                    engine.resume()
                metric.update_async(*b)
            engine.resume()
            engine.quiesce()

        jdir = os.path.join(workdir, f"osc-{name}-wal")
        ctrl = ServeController(copts)
        m = make()
        eng = m.serve(sopts, journal=_journal.Journal(jdir))
        ctrl.attach(eng)
        drive(m, eng)
        report = ctrl.channel_report(eng)
        n_transitions = sum(report["transitions"].values())
        n_control_events = sum(
            1 for e in obs.flightrec.events()
            if e["kind"] in ("control.decision", "control.escalation", "control.deescalation")
        )
        ok_toggle = ctrl.toggle_rate_ok(eng)
        ok_events = n_control_events >= n_transitions
        # the static comparison: on_full='shed' through the same seeded schedule
        ms = make()
        engs = ms.serve(ServeOptions(max_inflight=4, on_full="shed", queue_timeout_s=0.05, coalesce=4))
        drive(ms, engs)
        adaptive_shed, static_shed = eng.stats()["shed"], engs.stats()["shed"]
        ok_shed = adaptive_shed <= static_shed
        # bit-identity 1: a fresh instance, the WAL less the journaled sheds
        twin = make()
        adaptive_recover(twin, jdir)
        ok_replay = _states_identical(m, twin)
        # bit-identity 2: a twin from the bundle's journal cursor, with the same skips
        bundle_path = obs.capture_bundle(f"chaos_oscillating_load.{name}", metric=m)
        ok_bundle = None
        if bundle_path is not None:
            twin2 = make()
            _journal.recover(twin2, jdir, cursor=bundle_path,
                             skip_seqs=shed_seqs(os.fspath(jdir) + CONTROL_DIR_SUFFIX))
            ok_bundle = _states_identical(m, twin2)
        ok = ok_toggle and ok_events and ok_shed and ok_replay and ok_bundle is not False
        if ok:
            obs.telemetry.counter("robust.recovered").inc()
        passed = passed and ok
        detail[name] = {
            "toggles_under_cap": ok_toggle,
            "transitions": n_transitions,
            "decisions_as_flight_events": ok_events,
            "adaptive_shed": adaptive_shed,
            "static_shed": static_shed,
            "adaptive_not_worse": ok_shed,
            "adaptive_replay_identical": ok_replay,
            "bundle_replay_identical": ok_bundle,
            "escalations": ctrl.stats()["escalations"],
        }
    detail["passed"] = passed
    return detail


def scenario_online_window_preemption(
    factory: Callable[[], Any], rng: random.Random, n_batches: int, via: str, workdir: str
) -> Dict[str, Any]:
    """Windowed-metric preemption mid-overlap: ring, history and detector recovery (``chaos.py:1499``).

    A sliding-window metric (``online.Windowed``, plain and keyed variants) serves an async stream with a
    write-ahead journal at enqueue; part of the stream commits, the drain is held, more batches enter the
    window, and the engine is dropped cold mid-overlap. A fresh instance recovers ``snapshot +
    replay(journal)`` and finishes the stream. Window advances are a pure function of the update count, so the
    recovered run must be bit-identical in three layers: the window ring (every state buffer, bookkeeping
    scalars included), the per-window history (the continuation's values at each advance), and the drift
    detector's state (an EWMA band fed both histories). Templates that cannot be windowed (list states) fall
    back to a pinned ``MeanMetric``.
    """
    del via  # the windowed protocol is update-only (forward raises by contract)
    from torchmetrics_tpu_torch.aggregation import MeanMetric, SumMetric
    from torchmetrics_tpu_torch.keyed import KeyedMetric
    from torchmetrics_tpu_torch.online import EwmaBand, Windowed
    from torchmetrics_tpu_torch.robust import journal as _journal
    from torchmetrics_tpu_torch.serve import ServeOptions
    from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

    device = factory().device
    window, every = 3, 2
    n_batches = max(8, n_batches)
    preempt = rng.randrange(2, n_batches - 1)
    try:
        Windowed(factory(), window=window, advance_every=every, emit=False)
        plain_tpl: Callable[[], Any] = factory
        substituted = False
    except (TorchMetricsUserError, ValueError):
        plain_tpl = lambda: MeanMetric(device=device)  # noqa: E731  (an unwindowable template: pin one)
        substituted = True
    n_keys = 4
    keyed_batches = []
    for _ in range(n_batches):
        ids = np.asarray([rng.randrange(n_keys) for _ in range(5)], np.int32)
        vals = np.asarray([float(rng.randint(0, 9)) for _ in range(5)], np.float32)
        keyed_batches.append((ids, vals))
    variants: List[Tuple[str, Callable[[], Any], List[Tuple[Any, ...]]]] = [
        ("plain",
         lambda: Windowed(plain_tpl(), window=window, advance_every=every, emit=False),
         _seeded_batches(rng, n_batches)),
        ("keyed",
         lambda: Windowed(KeyedMetric(SumMetric, n_keys, device=device), window=window,
                          advance_every=every, emit=False),
         keyed_batches),
    ]

    def _drive_and_watch(m: Any, batches: List[Tuple[Any, ...]]) -> List[bytes]:
        """Apply ``batches`` synchronously, keeping the sliding value at every ring advance: the per-window
        history an ``online.*`` series would have seen."""
        history: List[bytes] = []
        seen = m.windows_advanced
        for b in batches:
            m.update(*b)
            if m.windows_advanced > seen:
                seen = m.windows_advanced
                history.append(_np(m.window_values()).tobytes())
        return history

    detail: Dict[str, Any] = {
        "preempt_step": preempt,
        "window": window,
        "advance_every": every,
        "template_substituted": substituted,
    }
    passed = True
    for name, make, batches in variants:
        jdir = f"{workdir}/online-preempt-{name}"
        m = make()
        eng = m.serve(ServeOptions(max_inflight=64), journal=_journal.Journal(jdir))
        split = max(1, (preempt + 1) // 2)
        for i in range(split):
            m.update_async(*batches[i])
        eng.quiesce()  # the prefix is committed ring state
        eng.pause()  # hold the drain: the rest stays IN the overlap window
        for i in range(split, preempt + 1):
            m.update_async(*batches[i])
        inj = PreemptMidOverlap()
        dropped = inj.strike(m)  # the process dies here; the WAL is the only survivor
        fresh = make()
        recovery = _journal.recover(fresh, jdir)
        obs.telemetry.counter("robust.recovered").inc()
        # post-mortem contract: replay from the strike bundle's journal cursor must rebuild the ring
        # (bookkeeping scalars included) byte-identically
        bundle_replay = _bundle_cursor_replay(make, jdir, fresh)
        continuation = _drive_and_watch(fresh, batches[preempt + 1:])
        ref = make()
        ref_history = _drive_and_watch(ref, batches)
        # layer 1: the ring itself, every buffer byte-identical
        ring_identical = all(_same_tensor(fresh._state.tensors[n], ref._state.tensors[n]) for n in fresh._state.tensors)
        value_identical = _identical(fresh.compute(), ref.compute())
        # layer 2: the per-window history, advance for advance
        history_identical = (
            continuation == ref_history[len(ref_history) - len(continuation):]
            if continuation else True
        )
        # layer 3: the detector state, an EWMA band over both histories (scalar windows only; a keyed ring emits
        # per-key vectors, which layer 2 covers)
        det_identical = True
        if ref_history and np.frombuffer(ref_history[0], np.float32).size == 1:
            det_ref, det_rec = EwmaBand(warmup=1), EwmaBand(warmup=1)
            recovered_history = ref_history[: len(ref_history) - len(continuation)] + continuation
            for h in ref_history:
                det_ref.observe(float(np.frombuffer(h, np.float32)[0]))
            for h in recovered_history:
                det_rec.observe(float(np.frombuffer(h, np.float32)[0]))
            det_identical = det_ref.state() == det_rec.state()
        ok = bool(
            ring_identical and value_identical and history_identical and det_identical
            and dropped > 0 and recovery["replayed"] == preempt + 1
            and fresh.windows_advanced == ref.windows_advanced
            and bundle_replay is not False
        )
        passed = passed and ok
        detail[name] = {
            "bit_identical": value_identical,
            "ring_identical": ring_identical,
            "history_identical": history_identical,
            "detector_identical": det_identical,
            "dropped_in_window": dropped,
            "replayed": recovery["replayed"],
            "windows_advanced": fresh.windows_advanced,
            "bundle_replay_identical": bundle_replay,
        }
    detail["passed"] = passed
    return detail


#: the ported scenarios, by the JAX package's ``ChaosMatrix.SCENARIOS`` names
SCENARIOS: Dict[str, Callable[..., Dict[str, Any]]] = {
    "rank_death_quorum_rejoin": scenario_rank_death_quorum_rejoin,
    "preemption_journal_replay": scenario_preemption_journal_replay,
    "keyed_preemption_journal": scenario_keyed_preemption_journal,
    "sketch_preemption_journal": scenario_sketch_preemption_journal,
    "flap_evict_readmit": scenario_flap_evict_readmit,
    "serve_preempt_mid_overlap": scenario_serve_preempt_mid_overlap,
    "serve_drain_death": scenario_serve_drain_death,
    "serve_queue_overflow": scenario_serve_queue_overflow,
    "serve_oscillating_load": scenario_serve_oscillating_load,
    "online_window_preemption": scenario_online_window_preemption,
}
