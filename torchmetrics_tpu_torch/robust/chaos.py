"""Deterministic fault injection for the serving tier (counterpart of the serving part of
``torchmetrics_tpu/robust/chaos.py``).

Each failure class of the async ingestion engine is a first-class injector that patches the REAL seam
(no test double of the engine):

==========================  ==============================================================
:class:`StagingTransferFailure`  ``serve.staging.device_put`` raises for the first N transfers: the
                                 pipeline must hand the host batch through, count
                                 ``serve.staging_fallbacks`` and warn once; values bit-identical
:class:`DrainThreadDeath`   ``IngestEngine._apply_window`` raises :class:`DrainKilled` once: the drain
                            hands its window back and dies; the restart latch must re-apply it FIFO
:class:`QueueOverflow`      the drain is held, so every enqueue past ``max_inflight`` meets the
                            configured ``on_full`` policy deterministically
:class:`PreemptMidOverlap`  the engine is abandoned cold with batches in its window: only the
                            write-ahead journal survives, and ``snapshot + replay`` recovers
==========================  ==============================================================

Every firing bumps ``robust.injected_faults``, records a ``chaos.injected`` flight event and captures a
post-mortem bundle, as the JAX package's injectors do. The rest of the JAX module (the sync and dispatch
injectors, ``SimWorld``, ``ChaosRunner``, the scenarios and ``ChaosMatrix``) waits on the bounded sync
(ROADMAP.md, queue A, item 9).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Iterator

from torchmetrics_tpu_torch import obs

#: env knob that pins the chaos seed (the serving tier's jittered park reads it)
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
