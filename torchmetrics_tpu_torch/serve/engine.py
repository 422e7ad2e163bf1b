"""The async ingestion engine: bounded in-flight window, FIFO drain, quiesce contract (counterpart of
``torchmetrics_tpu/serve/engine.py``).

``Metric.update_async`` enqueues a batch and returns an :class:`IngestTicket` future; a single background
drain thread applies enqueued batches strictly FIFO through the metric's ordinary synchronous dispatch
tiers (the captured-graph tier and the eager tier, bit-identical). Because the drain is the ONLY mutator
while the window is non-empty, the engine needs no per-state locking: every host access path
(``update``/``forward``/``compute``/``snapshot``/``sync``/``reset``) quiesces the window first, so user
code only ever observes a fully drained, exact state.

Throughput comes from two overlaps plus one structural win: the staging transfer runs in the caller while
the previous window computes; the caller's host work (request decode) runs while the drain dispatches;
and when traffic bursts ahead of the drain, consecutive same-shape batches in the window are COALESCED
through one ``update_batches`` step (``ServeOptions(coalesce=k)``; one graph replay on the card): k
dispatches become one. Coalescing changes launch shape only, never values (the stacked fold is
bit-identical with the sequential loop), and strictly preserves FIFO.

Streams. PyTorch's current stream is per thread, and a tensor carries no dependency on the work that
wrote it, so the engine orders the card's work itself:

- the drain applies each window on a stream of its own, after waiting on each batch's staging event
  (:meth:`StagingPipeline.ready`), which is recorded after the caller's prior work and the batch's copies;
- every staged device tensor is marked used on the drain's stream (``record_stream``), so the caching
  allocator does not hand its memory out again before the drain's work on it has run;
- :meth:`IngestEngine.quiesce` makes the caller's current stream wait on the drain's stream before it
  returns, so a ``compute()`` after ``quiesce()`` reads counts the drain has finished writing.

Crash consistency: when a journal is attached, the batch is appended durably at *enqueue* time, before it
is even pending in memory, so a preemption mid-overlap loses nothing: ``snapshot + replay(journal)``
re-drives the exact committed-plus-pending stream through the synchronous path, bit-identically.

Fault latches (driven by the chaos injectors in ``torchmetrics_tpu_torch.robust.chaos``):

- **drain-thread death** (:class:`DrainThreadDeath`): the in-hand window is returned to the queue head
  before the thread dies; the next quiesce/enqueue detects the dead thread, restarts it
  (``serve.drain_restarts``), and the restarted drain re-applies from the window: no batch applied twice,
  none lost.
- **queue overflow** (:class:`QueueOverflow`): the bounded window turns overflow into the configured
  backpressure (block / raise / shed) instead of unbounded growth.
- **staging transfer failure** (:class:`StagingTransferFailure`): absorbed inside
  :class:`~torchmetrics_tpu_torch.serve.staging.StagingPipeline`: unstaged host batches, same values.
- **apply failure**: the failing ticket records its error AND the engine latches it; the next quiesce
  raises :class:`ServeError` so a ``compute()`` can never silently omit a batch the caller believes was
  ingested.

The generation fence reads ``StateStore.generation``, which in this package counts the graph steps that
wrote the state in place (the JAX package counts donated dispatches): on the eager tier neither package's
fence sees a commit move it, and a foreign step between two commits breaks it on either tier.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor
from torch.utils._pytree import tree_flatten

from torchmetrics_tpu_torch.obs import bundle as _bundle
from torchmetrics_tpu_torch.obs import flightrec as _flightrec
from torchmetrics_tpu_torch.obs import telemetry
from torchmetrics_tpu_torch.obs import trace as _trace
from torchmetrics_tpu_torch.ops import dispatch as _dispatch
from torchmetrics_tpu_torch.serve.options import ServeOptions
from torchmetrics_tpu_torch.serve.staging import StagingPipeline
from torchmetrics_tpu_torch.utils.exceptions import BackpressureError, ServeError
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

#: initial/backoff-capped park times for a blocking enqueue (jittered between them)
_BLOCK_WAIT_MIN_S = 0.001
_BLOCK_WAIT_MAX_S = 0.25


def _target_device(target: Any) -> torch.device:
    """The device a target's state lives on: a metric's own, or a collection's first member's."""
    dev = getattr(target, "device", None)
    if isinstance(dev, torch.device):
        return dev
    members = getattr(target, "_modules", None)
    if members:
        return next(iter(members.values())).device
    return torch.device("cpu")


def _device_tensors(items: list) -> list:
    """The CUDA tensors among the window's batch leaves."""
    out = []
    for it in items:
        leaves, _ = tree_flatten((it[1], it[2]))
        out.extend(leaf for leaf in leaves if isinstance(leaf, Tensor) and leaf.is_cuda)
    return out


def _stack(leaves: list, device: torch.device) -> Tensor:
    """One stacked argument of a coalesced window, on the target's device: the staged tensors and the host
    arrays a skipped or failed staging handed through, in order. Each run of host arrays is stacked on the host
    and moved in one copy (one blocking transfer for the run, not one per batch)."""
    parts, run = [], []
    for x in leaves + [None]:
        if x is not None and not isinstance(x, Tensor):
            run.append(x)
            continue
        if run:
            parts.append(torch.as_tensor(np.stack([np.asarray(r) for r in run])).to(device))
            run = []
        if x is not None:
            parts.append(x.to(device).unsqueeze(0))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _jittered_wait(prev: float) -> float:
    """Next decorrelated-jitter park time for a blocked producer.

    ``min(cap, uniform(base, prev * 3))`` — the AWS "decorrelated jitter" recurrence,
    same shape as the JAX package's cross-process sync backoff. The RNG is the chaos-seeded one
    (``TM_TPU_CHAOS_SEED`` / ``reset_backoff_rng``), so chaos runs replay the exact park sequence,
    and many producers blocked on one full window wake scattered instead of retrying in lockstep.
    """
    from torchmetrics_tpu_torch.parallel.sync import _backoff_rng

    return min(
        _BLOCK_WAIT_MAX_S,
        _backoff_rng().uniform(_BLOCK_WAIT_MIN_S, max(_BLOCK_WAIT_MIN_S, prev * 3.0)),
    )


class DrainKilled(BaseException):
    """Chaos-only: simulates the drain thread dying between dequeue and apply.

    A ``BaseException`` so the ordinary apply-failure handler (which absorbs
    ``Exception``) cannot catch it — the thread genuinely terminates, exactly like an
    external kill, and recovery must go through the restart latch.
    """


class IngestTicket:
    """Lightweight future for one enqueued batch.

    ``wait``/``result`` resolve when the drain commits (or fails/sheds) the batch;
    ``generation`` is the :class:`StateStore` generation the commit landed at (the
    fence readers can compare against ``Metric.state_generation``). ``trace_id`` is the
    per-ticket trace/span id minted at enqueue while telemetry is enabled (None
    otherwise): the flow-event id linking the caller's enqueue slice to the drain
    thread's commit in the exported Perfetto trace.
    """

    __slots__ = ("seq", "shed", "error", "generation", "trace_id", "_event")

    def __init__(self, seq: int) -> None:
        self.seq = seq
        self.shed = False
        self.error: Optional[BaseException] = None
        self.generation: Optional[int] = None
        self.trace_id: Optional[int] = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> Optional[int]:
        """Block until resolved; raise the apply error if one fired, else return the
        committed state generation (``None`` for a shed ticket)."""
        if not self._event.wait(timeout):
            raise BackpressureError(
                f"IngestTicket #{self.seq} unresolved after {timeout}s"
            )
        if self.error is not None:
            raise self.error
        return self.generation

    def _resolve(self, generation: Optional[int] = None, error: Optional[BaseException] = None) -> None:
        self.generation = generation
        self.error = error
        self._event.set()

    def __repr__(self) -> str:
        state = "shed" if self.shed else ("done" if self.done() else "pending")
        return f"IngestTicket(seq={self.seq}, {state})"


class IngestEngine:
    """One metric's (or collection's) async ingestion window + drain thread."""

    def __init__(self, target: Any, options: Optional[ServeOptions] = None,
                 journal: Optional[Any] = None) -> None:
        self.target = target
        self.options = options or ServeOptions()
        self.journal = journal
        #: attached ServeController (the adaptive actuator tier) and/or SharedDrain
        #: owner (one drain thread serving many engines); None = static/per-engine
        self._control: Optional[Any] = None
        self._drain_owner: Optional[Any] = None
        self._device = _target_device(target)
        self._staging = StagingPipeline(self.options.staging_slots, device=self._device)
        #: the stream the drain applies on (a card's target only; made at the first window)
        self._stream: Optional[Any] = None
        self._cond = threading.Condition()
        #: (ticket, args, kwargs, slot, enqueue time, ready event) per enqueued batch
        self._queue: Deque[Tuple[IngestTicket, tuple, dict, Optional[int], float, Optional[Any]]] = deque()
        self._applying_n = 0  # batches popped from the queue and not yet committed
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._paused = False
        self._flush = False  # a quiescer is waiting: bypass the linger dwell
        self._abandoned = False
        self._seq = 0
        self._fence: Optional[int] = None  # StateStore generation after the last commit
        self._pending_error: Optional[BaseException] = None
        self._stats = {
            "enqueued": 0, "committed": 0, "shed": 0, "failed": 0,
            "drain_restarts": 0, "fence_breaks": 0, "backpressure_stalls": 0,
            "online_advances": 0,
        }

    # ------------------------------------------------------------------ window state
    @property
    def inflight(self) -> int:
        """Enqueued-but-uncommitted batches (including those being applied)."""
        with self._cond:
            return len(self._queue) + self._applying_n

    def stats(self) -> Dict[str, int]:
        with self._cond:
            out = dict(self._stats)
            out["inflight"] = len(self._queue) + self._applying_n
        return out

    # ---------------------------------------------------------------------- enqueue
    def enqueue(self, args: tuple, kwargs: dict) -> IngestTicket:
        """Stage one batch into the bounded window; returns its ticket.

        Journal append happens FIRST (write-ahead at enqueue time), then window
        admission under the ``on_full`` policy, then the staging transfer — so a batch
        that sheds was still journaled (replay reproduces the *offered* stream; the
        shed count says which suffix of it the live state dropped).
        """
        if self._abandoned:
            raise ServeError("This IngestEngine was abandoned (chaos preemption); build a fresh metric")
        wal_seq = self.journal.append(args, kwargs) if self.journal is not None else None
        ticket = self._admit(args, kwargs, wal_seq)
        owner = self._drain_owner
        if owner is not None:
            owner.kick()
        return ticket

    def attach_controller(self, control: Any) -> None:
        """Bind a :class:`~torchmetrics_tpu_torch.serve.control.ServeController` (its
        :meth:`attach` calls this); the drain reads dwell/coalesce through it and the
        admission path consults its block→timed→shed ladder."""
        with self._cond:
            self._control = control

    def _resolve_shed_locked(self, ticket: IngestTicket, reason: str = "window_full") -> IngestTicket:
        """Shed one offered batch (caller holds ``_cond``): resolve + count + events."""
        opts = self.options
        ticket.shed = True
        ticket._resolve()
        self._stats["shed"] += 1
        telemetry.counter("serve.shed").inc()
        telemetry.counter("robust.shed_batches").inc()
        # always-on live series: queue_depth records one point per OFFERED batch (the shed-ratio
        # denominator), serve.sheds the shed events themselves
        telemetry.series("serve.queue_depth", device=self._device).record(opts.max_inflight)
        telemetry.series("serve.sheds", device=self._device).record(1.0)
        _flightrec.record(
            "serve.shed", seq=ticket.seq, inflight=opts.max_inflight, reason=reason
        )
        _trace.shed_event(ticket.trace_id, ticket.seq)
        rank_zero_warn(
            f"Async ingestion window full ({opts.max_inflight} in flight):"
            f" shedding batches ({reason}). Shed counts are exact in"
            " serve.shed / IngestEngine.stats().",
            UserWarning,
        )
        return ticket

    def _admit(self, args: tuple, kwargs: dict, wal_seq: Optional[int] = None) -> IngestTicket:
        opts = self.options
        # one flag read on the tracing-disabled path
        t0_us = telemetry.now_us() if telemetry.enabled else 0.0
        with self._cond:
            self._ensure_drain_locked()
            ticket = IngestTicket(self._seq)
            self._seq += 1
            ctrl = self._control
            if self._window_full_locked():
                if opts.on_full == "raise":
                    raise BackpressureError(
                        f"Async ingestion window full ({opts.max_inflight} in flight)"
                        " and on_full='raise'"
                    )
                if opts.on_full == "shed":
                    mode, park_s = "shed", 0.0
                elif ctrl is not None:
                    # the escalating admission ladder: the controller may have moved a
                    # block engine to timed-block (shorter park budget) or shed
                    mode, park_s = ctrl.admission(self)
                else:
                    mode, park_s = "block", opts.queue_timeout_s
                if mode == "shed":
                    self._resolve_shed_locked(
                        ticket,
                        reason="on_full='shed'" if opts.on_full == "shed" else "admission=shed",
                    )
                    if ctrl is not None:
                        ctrl.note_offered(self, opts.max_inflight, shed=True, wal_seq=wal_seq)
                    return ticket
                # block / timed-block: park with decorrelated-jitter waits against the
                # rung's budget (chaos-seeded RNG — producers wake scattered, replayable)
                self._stats["backpressure_stalls"] += 1
                telemetry.counter("serve.backpressure_stalls").inc()
                _flightrec.record(
                    "serve.backpressure", seq=ticket.seq, inflight=opts.max_inflight,
                    mode=mode,
                )
                park_start = time.monotonic()
                wait = _BLOCK_WAIT_MIN_S
                while self._window_full_locked():
                    self._ensure_drain_locked()
                    if ctrl is not None:
                        # re-read the rung each wakeup: an escalation to shed releases
                        # every parked producer instead of letting them burn the budget
                        mode, park_s = ctrl.admission(self)
                        if mode == "shed":
                            self._resolve_shed_locked(ticket, reason="admission=shed")
                            ctrl.note_offered(self, opts.max_inflight, shed=True, wal_seq=wal_seq)
                            return ticket
                    remaining = park_start + park_s - time.monotonic()
                    if remaining <= 0:
                        telemetry.counter("serve.queue_timeouts").inc()
                        if ctrl is not None:
                            # with a controller attached an exhausted park budget sheds
                            # (a journaled, replayable decision) instead of raising —
                            # graceful degradation end to end
                            self._resolve_shed_locked(ticket, reason=f"{mode}_budget_exhausted")
                            ctrl.note_offered(self, opts.max_inflight, shed=True, wal_seq=wal_seq)
                            return ticket
                        raise BackpressureError(
                            f"Async ingestion enqueue blocked past queue_timeout_s="
                            f"{opts.queue_timeout_s:g}s with {opts.max_inflight} in flight"
                            " (is the drain stalled?)"
                        )
                    wait = _jittered_wait(wait)
                    self._cond.wait(min(wait, remaining))
            s_args, s_kwargs, slot = self._staging.stage(args, kwargs)
            # the trace id must exist BEFORE the batch is visible to the drain: the
            # commit's flow-end reads it, possibly before this thread leaves the lock.
            # Guarded here (not just inside mint) so the disabled path pays one flag
            # read, not a function call.
            if telemetry.enabled:
                ticket.trace_id = _trace.mint()
            ready = self._staging.ready(slot)
            self._queue.append((ticket, s_args, s_kwargs, slot, time.monotonic(), ready))
            self._stats["enqueued"] += 1
            depth = len(self._queue) + self._applying_n
            if ctrl is not None:
                # one controller tick per offered batch — the decision clock
                ctrl.note_offered(self, depth, shed=False, wal_seq=wal_seq)
            self._cond.notify_all()
        telemetry.counter("serve.enqueued").inc()
        telemetry.histogram("serve.queue_depth").record(depth)
        # ONE always-on series record per enqueue: each point is the live depth, so the series doubles as the offered-event
        # stream — rate_over() is the enqueue rate, the SLO shed-ratio denominator
        telemetry.series("serve.queue_depth", device=self._device).record(depth)
        if ticket.trace_id is not None:
            _trace.enqueue_span(ticket.trace_id, t0_us, ticket.seq, depth, slot)
        return ticket

    def _window_full_locked(self) -> bool:
        return len(self._queue) + self._applying_n >= self.options.max_inflight

    # ------------------------------------------------------------------------ drain
    def _ensure_drain_locked(self) -> None:
        """(Re)start the drain thread; the restart path is the thread-death latch."""
        owner = self._drain_owner
        if owner is not None:
            # a SharedDrain owns this engine: its restart latch covers thread death
            # for the whole fleet of attached engines; no per-engine thread exists
            owner.ensure_alive()
            owner.kick()
            return
        t = self._thread
        if t is not None and t.is_alive():
            return
        if t is not None:  # a previous drain died (chaos DrainThreadDeath, or a crash)
            if not self.options.restart_drain:
                # incident first: the drain-death flight events must carry the id the
                # bundle (and the federation gossip) will advertise
                _flightrec.open_incident("serve_drain_death")
                _flightrec.record(
                    "serve.drain_restart", pending=len(self._queue), restarted=False
                )
                _bundle.capture_bundle("serve_drain_death", metric=self.target)
                raise ServeError(
                    "The ingestion drain thread died and restart_drain is off; the"
                    f" window holds {len(self._queue)} unapplied batch(es)."
                )
            self._stats["drain_restarts"] += 1
            telemetry.counter("serve.drain_restarts").inc()
            # a drain death is a real failure seam even when the latch recovers it:
            # land the post-mortem bundle, then restart
            _flightrec.open_incident("serve_drain_death")
            _flightrec.record(
                "serve.drain_restart", pending=len(self._queue),
                restarts=self._stats["drain_restarts"],
            )
            _bundle.capture_bundle("serve_drain_death", metric=self.target)
            rank_zero_warn(
                "The async ingestion drain thread died; restarting it. Batches still in"
                " the window will be re-applied in FIFO order (none were committed).",
                UserWarning,
            )
        self._stop = False
        self._thread = threading.Thread(
            target=self._drain_loop, daemon=True, name="tm-tpu-torch-serve-drain"
        )
        self._thread.start()

    def _effective_linger_s(self) -> float:
        """Live micro-batching dwell: the controller's actuator position when one is
        attached, else the static option — re-read every window, not once per loop."""
        ctrl = self._control
        if ctrl is not None:
            return ctrl.linger_ms(self) / 1000.0
        return self.options.linger_ms / 1000.0

    def _effective_coalesce(self) -> int:
        ctrl = self._control
        if ctrl is not None:
            return int(ctrl.coalesce(self))
        return self.options.coalesce

    def _is_drain_thread(self) -> bool:
        """Is the current thread the one draining this engine (own or shared)?"""
        if threading.current_thread() is self._thread:
            return True
        owner = self._drain_owner
        return owner is not None and owner.is_drain_thread()

    def _drain_loop(self) -> None:
        _trace.note_thread("serve-drain")  # label this track in the exported trace
        while True:
            if self._drain_once(wait=True) in ("stop", "killed"):
                return

    def _drain_once(self, wait: bool = True) -> str:
        """Apply at most one coalesced window; returns the outcome.

        ``"applied"`` — a window left the queue (committed or failed); ``"idle"`` —
        nothing ready (empty/paused, or a non-blocking call found the linger dwell
        still running); ``"stop"`` — the engine is stopping and the queue is empty;
        ``"killed"`` — chaos :class:`DrainKilled` fired and the calling thread must
        terminate. ``wait=True`` is the dedicated-drain mode (blocks for work and
        dwells in-lock); ``wait=False`` is the :class:`SharedDrain` quantum — never
        blocks, so one thread can round-robin many engines.
        """
        linger_s = self._effective_linger_s()
        coalesce = self._effective_coalesce()
        with self._cond:
            if wait:
                while (not self._queue or self._paused) and not self._stop:
                    self._cond.wait()
            if self._stop and not self._queue:
                return "stop"
            if (self._paused and not self._stop) or not self._queue:
                return "idle"
            if linger_s > 0 and not (self._flush or self._stop):
                # micro-batching dwell: give the enqueueing thread up to linger_ms
                # to fill a coalescible window before launching (bypassed the
                # moment a quiescer waits or the window is already full-width)
                if wait:
                    while (
                        0 < len(self._queue) < coalesce
                        and not (self._flush or self._stop or self._paused)
                    ):
                        remaining = self._queue[0][4] + linger_s - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(remaining)
                    if not self._queue or self._paused:
                        return "idle"
                elif (
                    0 < len(self._queue) < coalesce
                    and self._queue[0][4] + linger_s - time.monotonic() > 0
                ):
                    return "idle"  # dwell unexpired; the shared drain comes back
            items = [self._queue.popleft()]
            if coalesce > 1 and self._queue:
                # coalesce consecutive same-shape batches into one stacked step:
                # k dispatches become 1 (the update_batches tier), FIFO preserved.
                # Widths are quantized to powers of two so the captured stacked-step
                # signatures stay bounded at log2(coalesce) + 1 shapes: an arbitrary
                # width would capture a fresh graph per distinct burst size.
                key0 = _dispatch._batch_key(items[0][1], items[0][2])
                while self._queue and len(items) < coalesce:
                    head = self._queue[0]
                    if _dispatch._batch_key(head[1], head[2]) != key0:
                        break
                    items.append(self._queue.popleft())
                width = 1 << (len(items).bit_length() - 1)
                while len(items) > width:  # hand the overshoot back, order intact
                    self._queue.appendleft(items.pop())
            self._applying_n = len(items)
            inflight_now = len(self._queue) + self._applying_n
        width = len(items)
        tier = "update" if width == 1 else "update_batches"
        telemetry.series("serve.inflight", device=self._device).record(inflight_now)
        t_apply0 = 0.0
        if telemetry.enabled:
            t_apply0 = telemetry.now_us()
            for it in items:
                if width > 1:
                    _trace.coalesced_event(it[0].trace_id, width)
                _trace.dispatched_event(it[0].trace_id, tier, width)
        try:
            if self._device.type == "cuda":
                self._apply_on_stream(items)
            else:
                self._apply_window(items)
        except DrainKilled:
            # the thread is dying between dequeue and apply: hand the window back
            # (nothing was committed) so the restart latch re-applies it FIFO, then
            # terminate without the default excepthook spew — the death is
            # observable via the dead thread, exactly like an external kill
            with self._cond:
                self._queue.extendleft(reversed(items))
                self._applying_n = 0
                self._cond.notify_all()
            for it in items:
                self._staging.release(it[3])
            return "killed"
        except Exception as err:  # noqa: BLE001 - a bad batch must not kill the drain
            telemetry.counter("serve.apply_failures").inc(len(items))
            _flightrec.record(
                "serve.apply_failure", batches=len(items), error=repr(err)[:200]
            )
            for it in items:
                it[0]._resolve(error=err)
                _trace.failed_event(it[0].trace_id, repr(err))
            with self._cond:
                # stats share _cond with the admission counters: the main thread
                # bumps "enqueued"/"shed" under it, so the drain's failure count
                # must too or the += load/store pair loses updates
                self._stats["failed"] += len(items)
                if self._pending_error is None:
                    self._pending_error = err
                self._applying_n = 0
                self._cond.notify_all()
        else:
            telemetry.counter("serve.committed").inc(len(items))
            if len(items) > 1:
                telemetry.counter("serve.coalesced_launches").inc()
            # always-on: commit-event + enqueue->commit latency series (the SLO
            # commit-latency feed), then the trace closes each ticket's flow on
            # THIS (drain) thread — the caller->drain link Perfetto draws
            now_mono = time.monotonic()
            lat_series = telemetry.series("serve.commit_latency_us", device=self._device)
            commits = telemetry.series("serve.commits", device=self._device)
            for it in items:
                lat_series.record((now_mono - it[4]) * 1e6)
                commits.record(1.0)
            if telemetry.enabled:
                _trace.apply_span(t_apply0, width, tier)
                for it in items:
                    _trace.committed_event(
                        it[0].trace_id, (now_mono - it[4]) * 1e6, it[0].generation
                    )
            with self._cond:
                self._stats["committed"] += len(items)
                self._applying_n = 0
                if self._control is not None:
                    # commits relieve pressure between offered ticks; let the next
                    # decision see the drained depth, not the pre-commit burst
                    self._control.note_committed(self, len(items))
                self._cond.notify_all()
        finally:
            for it in items:
                self._staging.release(it[3])
        return "applied"

    def _drain_stream(self) -> Any:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
        return self._stream

    def _apply_on_stream(self, items: list) -> None:
        """:meth:`_apply_window` on the drain's stream, after each batch's staging event, with every
        device tensor of the window marked used there (the allocator must not reuse it early)."""
        stream = self._drain_stream()
        with torch.cuda.device(self._device), torch.cuda.stream(stream):
            for it in items:
                if it[5] is not None:
                    stream.wait_event(it[5])
            for t in _device_tensors(items):
                t.record_stream(stream)
            self._apply_window(items)

    def _apply_window(self, items: list) -> None:
        """Apply one FIFO window of batches through the target's synchronous tiers.

        A single batch drives ``update``; a coalesced window stacks the batches and
        drives ``update_batches`` (one fused step, bit-identical with the sequential
        loop by the tier-equivalence contract). The generation fence:
        between two drain commits nothing else may move the target's
        :class:`StateStore` generation — a move means some other thread mutated state
        while the window was non-empty (a quiesce-contract violation), which is
        counted and warned, never silent.
        """
        store = getattr(self.target, "_state", None)
        if store is not None and self._fence is not None and store.generation != self._fence:
            with self._cond:  # stats share _cond with the main thread's admission counters
                self._stats["fence_breaks"] += 1
            telemetry.counter("serve.fence_breaks").inc()
            _flightrec.record(
                "serve.fence_break", expected=self._fence, observed=store.generation
            )
            _trace.fence_break_event(self._fence, store.generation)
            rank_zero_warn(
                "Async ingestion generation fence broke: the metric state moved"
                f" (generation {self._fence} -> {store.generation}) while batches were"
                " in flight. Some non-drain code mutated state without quiescing the"
                " window first.",
                UserWarning,
            )
        # windowed targets (torchmetrics_tpu_torch.online) advance their ring in-graph as
        # the drain applies batches (update-count ticks — deterministic under WAL
        # replay); the host-side advance counter diff attributes those advances to
        # the drain without any device read
        advances_before = getattr(self.target, "windows_advanced", None)
        if len(items) == 1:
            args, kwargs = items[0][1], items[0][2]
            self.target.update(*args, **kwargs)
        else:
            first_args, first_kwargs = items[0][1], items[0][2]
            stacked_args = tuple(
                _stack([it[1][i] for it in items], self._device) for i in range(len(first_args))
            )
            stacked_kwargs = {
                name: _stack([it[2][name] for it in items], self._device) for name in first_kwargs
            }
            self.target.update_batches(*stacked_args, **stacked_kwargs)
        if advances_before is not None:
            advanced = self.target.windows_advanced - advances_before
            if advanced > 0:
                with self._cond:
                    self._stats["online_advances"] += advanced
                telemetry.counter("serve.online_advances").inc(advanced)
        gen = store.generation if store is not None else None
        # Sole-writer protocol, not a lock: while batches are in flight only the drain
        # advances the fence, and quiesce() only clears it after the window is provably
        # empty (it holds _cond and waited for _queue and _applying_n to hit zero) — so
        # the two writers are separated by the quiesce barrier, never overlapped.
        self._fence = gen
        for it in items:
            it[0]._resolve(generation=gen)

    # ---------------------------------------------------------------------- quiesce
    def quiesce(self, timeout: Optional[float] = None) -> None:
        """Block until the window is empty (called by every host access path).

        No-op from the drain thread itself (the drain calling ``target.update`` must
        not wait on its own queue). Restarts a dead drain when batches are pending;
        re-raises the first deferred apply error so a drained state is either exact or
        loudly incomplete, never silently short. On a card, the caller's current stream
        then waits on the drain's stream, so what the caller reads next sees every commit.
        """
        if self._is_drain_thread():
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            self._flush = True  # bypass the linger dwell: a reader is waiting
            self._cond.notify_all()
            try:
                while self._queue or self._applying_n:
                    self._ensure_drain_locked()
                    if deadline is not None and time.monotonic() >= deadline:
                        raise ServeError(
                            f"quiesce timed out with {len(self._queue)} batch(es) still in"
                            " the ingestion window"
                        )
                    self._cond.wait(0.05)
            finally:
                self._flush = False
            # an empty window means user code may mutate state freely until the next
            # enqueue; drop the fence so legitimate post-quiesce mutations don't trip it
            self._fence = None
            err, self._pending_error = self._pending_error, None
            stream = self._stream
        if stream is not None:
            torch.cuda.current_stream(self._device).wait_stream(stream)
        if err is not None:
            # the deferred apply failure surfaces HERE (the drain already recorded the
            # apply_failure event); capture the bundle before the raise reaches user code
            _flightrec.open_incident("serve_apply_failure")
            _bundle.capture_bundle("serve_apply_failure", metric=self.target)
            raise ServeError(
                f"A batch enqueued via update_async failed to apply: {err!r}. The"
                " metric state holds every batch before it; the failed batch is NOT"
                " included."
            ) from err

    # ------------------------------------------------------------- chaos/test seams
    def pause(self) -> None:
        """Hold the drain (QueueOverflow chaos: fills the window deterministically)."""
        with self._cond:
            self._paused = True
            self._cond.notify_all()

    def resume(self) -> None:
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def abandon(self) -> int:
        """Chaos preemption: drop the engine cold, window and all; returns the number of
        batches that were in flight. The journal (appended at enqueue) is the only
        survivor — recovery is ``snapshot + replay(journal)`` on a FRESH metric."""
        with self._cond:
            dropped = len(self._queue) + self._applying_n
            for it in self._queue:  # close every in-window flow: no dangling trace ids
                _trace.abandoned_event(it[0].trace_id)
            self._queue.clear()
            self._paused = False
            self._stop = True
            self._abandoned = True
            self._cond.notify_all()
        # the preemption seam: the dropped window only survives in the write-ahead
        # journal, and the bundle records its cursor: post-mortem replay from it is
        # bit-identical
        _flightrec.open_incident("serve_abandoned")
        _flightrec.record("serve.abandoned", dropped_in_window=dropped)
        _bundle.capture_bundle("serve_abandoned", metric=self.target)
        return dropped

    def close(self) -> None:
        """Drain outstanding batches, then stop the thread (idempotent)."""
        self.quiesce()
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        owner = self._drain_owner
        if owner is not None:
            # the shared thread keeps serving its other engines; just stop being one
            owner.detach(self)
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
