"""The actuator tier: a deterministic control loop over the serving signal stack (counterpart of
``torchmetrics_tpu/serve/control.py``).

``ServeOptions`` is a static config, so without a controller an overload ends in sheds and a post-mortem
bundle instead of adaptation. :class:`ServeController` closes the loop from signals to actions:

- **Adaptive coalesce/linger**: the micro-batching dwell (``linger_ms``) and the coalesce width track
  queue occupancy: a backed-up queue with a healthy latency budget raises the dwell (wider stacked
  launches), occupancy at the saturation band (Little's law makes window occupancy the deterministic
  enqueue-to-commit latency proxy) collapses it so commits launch immediately.
- **Escalating admission**: a ``block`` engine graduates block -> timed-block -> shed as the
  multi-window occupancy burn crosses the escalation band, and de-escalates symmetrically on recovery.
  Each rung is a park budget: ``block`` parks up to ``queue_timeout_s``, ``timed`` up to
  ``timed_block_timeout_s``, ``shed`` not at all; with a controller attached, an exhausted park budget
  *sheds* (a journaled decision) instead of raising.
- **Shared drain**: :class:`SharedDrain` runs ONE drain thread across many engines, scheduled by
  weighted deficit round-robin on per-engine burn (occupancy + shed burn): a hot tenant earns more
  quanta, but every engine keeps the base quantum.
- **Drift-triggered auto-snapshot**: :class:`DriftSnapshotter` keeps a rolling pre-shift snapshot while
  the detectors of a :class:`~torchmetrics_tpu_torch.online.drift.DriftMonitor` are quiet; the evaluation
  that fires an alarm lands the pre-shift blob + an at-alarm blob + a post-mortem bundle.

**Determinism contract.** The decision path reads only update-count/queue-state derived signals: the
tick counter is the offered-batch count, the burn windows are tick-indexed rings of window occupancy,
never the wall clock (a clocked decision is irreproducible under replay). Hysteresis bands plus a
per-actuator decision-rate cap (``min_hold_ticks``) bound actuator toggles to at most one per actuator
per ``min_hold_ticks`` offered batches. Every transition and every controller shed is (1) a
flight-recorder event carrying the triggering signal values and (2) a record in the **decision
journal**, a :class:`~torchmetrics_tpu_torch.robust.journal.Journal` beside the WAL (``<wal>-control``),
in the JAX package's record format, so either package replays the other's. :func:`adaptive_recover`
replays the WAL skipping exactly the journaled shed sequence numbers, which is the whole effect the
controller had on *values*.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, FrozenSet, List, Optional, Tuple

from torchmetrics_tpu_torch.obs import bundle as _bundle
from torchmetrics_tpu_torch.obs import flightrec as _flightrec
from torchmetrics_tpu_torch.obs import telemetry
from torchmetrics_tpu_torch.obs import trace as _trace
from torchmetrics_tpu_torch.serve.options import ServeOptions, _env_num
from torchmetrics_tpu_torch.utils.exceptions import ServeError

ENV_CONTROL_DECISION_EVERY = "TM_TPU_SERVE_CONTROL_DECISION_EVERY"
ENV_CONTROL_MIN_HOLD = "TM_TPU_SERVE_CONTROL_MIN_HOLD_TICKS"
ENV_CONTROL_WINDOW_SHORT = "TM_TPU_SERVE_CONTROL_WINDOW_SHORT"
ENV_CONTROL_WINDOW_LONG = "TM_TPU_SERVE_CONTROL_WINDOW_LONG"
ENV_CONTROL_TIMED_TIMEOUT = "TM_TPU_SERVE_CONTROL_TIMED_TIMEOUT_S"
ENV_CONTROL_LINGER_MAX = "TM_TPU_SERVE_CONTROL_LINGER_MAX_MS"

#: the admission ladder, least → most degraded; the index is the escalation level
MODES: Tuple[str, ...] = ("block", "timed", "shed")

#: control-journal directory suffix beside the engine's WAL directory
CONTROL_DIR_SUFFIX = "-control"


@dataclass(frozen=True)
class ControlOptions:
    """Policy for one :class:`ServeController`.

    All cadences and windows are in *offered-batch ticks*, never seconds — the
    controller's clock is the update count. ``min_hold_ticks`` is the
    per-actuator decision-rate cap: once an actuator changed, it holds for at least
    this many offered batches regardless of what the signals do, which is what makes
    square-wave load thrash-free. The occupancy bands are hysteresis pairs —
    escalation needs the *short and long* window averages above the high band,
    de-escalation needs both below the low band.
    """

    #: run the decision function every this-many offered batches
    decision_every: int = 8
    #: short / long burn windows (offered-batch ticks) for the multi-window burn test
    window_short: int = 16
    window_long: int = 64
    #: per-actuator decision-rate cap: minimum offered-batch ticks between changes
    min_hold_ticks: int = 32
    #: admission ladder hysteresis band (mean window occupancy, 0..1)
    escalate_occupancy: float = 0.85
    deescalate_occupancy: float = 0.35
    #: dwell hysteresis band: raise dwell above the high edge (queue backing up,
    #: latency budget healthy), lower it below the low edge; occupancy at the
    #: escalation band collapses the dwell outright (the p99-burn proxy)
    dwell_raise_occupancy: float = 0.40
    dwell_lower_occupancy: float = 0.15
    #: dwell actuation range/step; coalesce moves by powers of two down to the floor
    linger_max_ms: float = 2.0
    linger_step_ms: float = 0.5
    coalesce_min: int = 1
    #: park budget of the middle admission rung (behavioural, not decisional: the
    #: decision to *be* in timed mode came from tick-derived burn, never the clock)
    timed_block_timeout_s: float = 0.05

    def __post_init__(self) -> None:
        if int(self.decision_every) < 1:
            raise ServeError(f"ControlOptions(decision_every) needs >= 1, got {self.decision_every}")
        if int(self.window_short) < 1:
            raise ServeError(f"ControlOptions(window_short) needs >= 1, got {self.window_short}")
        if int(self.window_long) < int(self.window_short):
            raise ServeError(
                f"ControlOptions(window_long) needs >= window_short, got {self.window_long}"
            )
        if int(self.min_hold_ticks) < 1:
            raise ServeError(f"ControlOptions(min_hold_ticks) needs >= 1, got {self.min_hold_ticks}")
        if not (0.0 < self.deescalate_occupancy < self.escalate_occupancy <= 1.0):
            raise ServeError(
                "ControlOptions needs 0 < deescalate_occupancy < escalate_occupancy <= 1,"
                f" got ({self.deescalate_occupancy}, {self.escalate_occupancy})"
            )
        if not (0.0 <= self.dwell_lower_occupancy < self.dwell_raise_occupancy <= 1.0):
            raise ServeError(
                "ControlOptions needs 0 <= dwell_lower_occupancy < dwell_raise_occupancy <= 1,"
                f" got ({self.dwell_lower_occupancy}, {self.dwell_raise_occupancy})"
            )
        if float(self.linger_max_ms) < 0 or float(self.linger_step_ms) <= 0:
            raise ServeError(
                f"ControlOptions(linger_max_ms/linger_step_ms) need >= 0 / > 0, got"
                f" ({self.linger_max_ms}, {self.linger_step_ms})"
            )
        if int(self.coalesce_min) < 1:
            raise ServeError(f"ControlOptions(coalesce_min) needs >= 1, got {self.coalesce_min}")
        if float(self.timed_block_timeout_s) < 0:
            raise ServeError(
                f"ControlOptions(timed_block_timeout_s) needs >= 0, got {self.timed_block_timeout_s}"
            )


def control_options_from_env() -> ControlOptions:
    """Build :class:`ControlOptions` from the ``TM_TPU_SERVE_CONTROL_*`` env knobs.

    Malformed values degrade to the defaults with a one-shot rank-zero warning, same
    contract as :func:`~torchmetrics_tpu_torch.serve.options.serve_options_from_env`.
    """
    return ControlOptions(
        decision_every=_env_num(ENV_CONTROL_DECISION_EVERY, 8, int, lambda v: v >= 1),
        window_short=_env_num(ENV_CONTROL_WINDOW_SHORT, 16, int, lambda v: v >= 1),
        window_long=_env_num(ENV_CONTROL_WINDOW_LONG, 64, int, lambda v: v >= 1),
        min_hold_ticks=_env_num(ENV_CONTROL_MIN_HOLD, 32, int, lambda v: v >= 1),
        timed_block_timeout_s=_env_num(ENV_CONTROL_TIMED_TIMEOUT, 0.05, float, lambda v: v >= 0),
        linger_max_ms=_env_num(ENV_CONTROL_LINGER_MAX, 2.0, float, lambda v: v >= 0),
    )


class _Channel:
    """Per-engine actuator + signal state (controller-private, guarded by the
    controller lock). The actuator fields (``mode_idx``/``linger_ms``/``coalesce``)
    are only ever written by :meth:`ServeController._transition` — the single seam
    that also lands the flight event and the decision-journal record."""

    def __init__(self, engine: Any, opts: ControlOptions) -> None:
        self.engine = engine
        base: ServeOptions = engine.options
        self.mode_idx = 0
        self.linger_ms = float(base.linger_ms)
        self.coalesce = int(base.coalesce)
        self.tick = 0
        #: one occupancy sample per offered batch — the tick-indexed burn window
        self.occ_ring: Deque[float] = deque(maxlen=int(opts.window_long))
        self.shed_ring: Deque[int] = deque(maxlen=int(opts.window_long))
        self.last_change: Dict[str, int] = {"admission": -(10**9), "dwell": -(10**9)}
        self.transitions: Dict[str, int] = {"admission": 0, "dwell": 0}
        self.journal: Optional[Any] = None

    def occupancy(self, window: int) -> float:
        if not self.occ_ring:
            return 0.0
        n = min(window, len(self.occ_ring))
        tail = list(self.occ_ring)[-n:]
        return sum(tail) / n

    def shed_burn(self, window: int) -> float:
        if not self.shed_ring:
            return 0.0
        n = min(window, len(self.shed_ring))
        tail = list(self.shed_ring)[-n:]
        return sum(tail) / n


class ServeController:
    """Deterministic signals→actions loop for one or more :class:`IngestEngine` s.

    Attach with :meth:`attach` (or ``metric.serve(control=...)``). The engine calls
    :meth:`note_offered` once per offered batch under its own condition lock; every
    ``decision_every`` ticks the controller evaluates the tick-windowed occupancy
    burn and moves the actuators through :meth:`_transition` — the only mutation
    seam, which journals the decision and lands the flight event with the triggering
    signal values. All engine-facing reads (:meth:`linger_ms` / :meth:`coalesce` /
    :meth:`admission`) are plain attribute loads — nothing on the drain hot path
    blocks on the controller lock.
    """

    def __init__(self, options: Optional[ControlOptions] = None) -> None:
        self.options = options or ControlOptions()
        self._lock = threading.Lock()
        self._channels: Dict[int, _Channel] = {}
        self._stats = {
            "ticks": 0, "decisions": 0, "escalations": 0, "deescalations": 0,
            "dwell_changes": 0, "sheds": 0,
        }
        #: in-memory decision log (the durable twin rides the control journal)
        self.decisions: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------ attachment
    def attach(self, engine: Any) -> Any:
        """Bind this controller to ``engine``; returns the engine.

        When the engine carries a write-ahead journal, the decision journal opens
        beside it (``<wal>-control``) so replay can subtract the journaled sheds.
        """
        with self._lock:
            ch = self._channels.get(id(engine))
            if ch is None:
                ch = _Channel(engine, self.options)
                if getattr(engine.journal, "path", None):
                    from torchmetrics_tpu_torch.robust.journal import Journal

                    ch.journal = Journal(os.fspath(engine.journal.path) + CONTROL_DIR_SUFFIX)
                self._channels[id(engine)] = ch
        engine.attach_controller(self)
        _flightrec.record(
            "control.attach", engines=len(self._channels),
            journaled=ch.journal is not None,
        )
        return engine

    def _channel(self, engine: Any) -> _Channel:
        ch = self._channels.get(id(engine))
        if ch is None:
            raise ServeError("This engine is not attached to the controller; call attach() first")
        return ch

    # ----------------------------------------------------- engine-facing actuators
    def linger_ms(self, engine: Any) -> float:
        """Live micro-batching dwell for ``engine`` (read by the drain each window)."""
        return self._channel(engine).linger_ms

    def coalesce(self, engine: Any) -> int:
        """Live coalesce width for ``engine`` (read by the drain each window)."""
        return self._channel(engine).coalesce

    def admission(self, engine: Any) -> Tuple[str, float]:
        """Effective admission rung for a full window: ``(mode, park_budget_s)``."""
        ch = self._channel(engine)
        mode = MODES[ch.mode_idx]
        if mode == "block":
            return mode, float(engine.options.queue_timeout_s)
        if mode == "timed":
            return mode, float(self.options.timed_block_timeout_s)
        return mode, 0.0

    def shed_burn(self, engine: Any) -> float:
        """Short-window shed fraction — the :class:`SharedDrain` weight component."""
        return self._channel(engine).shed_burn(self.options.window_short)

    # --------------------------------------------------------------- signal intake
    def note_offered(self, engine: Any, depth: int, shed: bool = False,
                     wal_seq: Optional[int] = None) -> None:
        """One offered batch: sample queue state, journal a shed, maybe decide.

        Called by the engine under its own condition lock, once per ``enqueue`` —
        the tick counter this advances IS the controller's clock (update-count
        derived, never wall time). ``depth`` is the window depth the offer observed;
        ``wal_seq`` is the batch's write-ahead journal sequence number, recorded on a
        shed so :func:`adaptive_recover` can skip exactly the dropped records.
        """
        opts = self.options
        with self._lock:
            ch = self._channel(engine)
            ch.tick += 1
            self._stats["ticks"] += 1
            ch.occ_ring.append(min(1.0, depth / float(engine.options.max_inflight)))
            ch.shed_ring.append(1 if shed else 0)
            if shed:
                self._stats["sheds"] += 1
                self._note_shed_locked(ch, wal_seq)
            if ch.tick % opts.decision_every == 0:
                self._decide_locked(ch)

    def note_committed(self, engine: Any, n: int) -> None:
        """Drain-side commit notification (kept for scheduling weight freshness)."""
        with self._lock:
            ch = self._channels.get(id(engine))
            if ch is not None and ch.occ_ring:
                # commits relieve pressure between offers; reflect the drained depth
                # so a quiet stream's next decision sees the recovery, not the burst
                depth = len(engine._queue) + engine._applying_n
                ch.occ_ring[-1] = min(1.0, depth / float(engine.options.max_inflight))

    def _note_shed_locked(self, ch: _Channel, wal_seq: Optional[int]) -> None:
        mode = MODES[ch.mode_idx]
        _flightrec.record("control.shed", seq=wal_seq, mode=mode, tick=ch.tick)
        if ch.journal is not None and wal_seq is not None:
            ch.journal.append(("shed", {"seq": int(wal_seq), "mode": mode, "tick": ch.tick}))

    # -------------------------------------------------------------- decision core
    def _decide_locked(self, ch: _Channel) -> None:
        opts = self.options
        self._stats["decisions"] += 1
        occ_s = ch.occupancy(opts.window_short)
        occ_l = ch.occupancy(opts.window_long)
        self._decide_admission_locked(ch, occ_s, occ_l)
        self._decide_dwell_locked(ch, occ_s, occ_l)

    def _held(self, ch: _Channel, actuator: str) -> bool:
        return ch.tick - ch.last_change[actuator] < self.options.min_hold_ticks

    def _decide_admission_locked(self, ch: _Channel, occ_s: float, occ_l: float) -> None:
        if ch.engine.options.on_full != "block":
            return  # the ladder only governs engines whose base contract is block
        opts = self.options
        if self._held(ch, "admission"):
            return
        # multi-window burn: escalate only when the pressure is sustained (long
        # window) AND still happening (short window); de-escalate symmetrically
        if ch.mode_idx < len(MODES) - 1 and occ_s >= opts.escalate_occupancy \
                and occ_l >= opts.escalate_occupancy:
            self._transition(ch, "admission", ch.mode_idx + 1, occ_s, occ_l)
        elif ch.mode_idx > 0 and occ_s <= opts.deescalate_occupancy \
                and occ_l <= opts.deescalate_occupancy:
            self._transition(ch, "admission", ch.mode_idx - 1, occ_s, occ_l)

    def _decide_dwell_locked(self, ch: _Channel, occ_s: float, occ_l: float) -> None:
        opts = self.options
        if self._held(ch, "dwell"):
            return
        base: ServeOptions = ch.engine.options
        linger, coalesce = ch.linger_ms, ch.coalesce
        if occ_s >= opts.escalate_occupancy:
            # p99 burn rising (saturation band): collapse the dwell — a deep queue
            # coalesces without lingering, and every extra dwell-ms is pure latency
            linger, coalesce = 0.0, int(base.coalesce)
        elif occ_s >= opts.dwell_raise_occupancy:
            # queue backing up, latency budget healthy: raise the dwell
            linger = min(opts.linger_max_ms, ch.linger_ms + opts.linger_step_ms)
            coalesce = min(int(base.coalesce), max(1, ch.coalesce) * 2)
        elif occ_s <= opts.dwell_lower_occupancy:
            linger = max(0.0, ch.linger_ms - opts.linger_step_ms)
            coalesce = max(int(opts.coalesce_min), ch.coalesce // 2)
        if (linger, coalesce) != (ch.linger_ms, ch.coalesce):
            self._transition(ch, "dwell", (linger, coalesce), occ_s, occ_l)

    def _transition(self, ch: _Channel, actuator: str, to: Any,
                    occ_s: float, occ_l: float) -> None:
        """THE actuator mutation seam: move state + flight event + decision journal.

        Every escalate/de-escalate/dwell change funnels through here so the flight
        recorder and the decision journal see each transition with the triggering
        signal values.
        """
        if actuator == "admission":
            frm, ch.mode_idx = MODES[ch.mode_idx], int(to)
            to_name = MODES[ch.mode_idx]
            escalated = MODES.index(to_name) > MODES.index(frm)
            self._stats["escalations" if escalated else "deescalations"] += 1
            kind = "control.escalation" if escalated else "control.deescalation"
        else:
            frm = (ch.linger_ms, ch.coalesce)
            ch.linger_ms, ch.coalesce = float(to[0]), int(to[1])
            to_name = (ch.linger_ms, ch.coalesce)
            self._stats["dwell_changes"] += 1
            kind = "control.decision"
        ch.last_change[actuator] = ch.tick
        ch.transitions[actuator] += 1
        decision = {
            "kind": kind, "actuator": actuator, "from": frm, "to": to_name,
            "tick": ch.tick, "occupancy_short": round(occ_s, 4),
            "occupancy_long": round(occ_l, 4),
        }
        self.decisions.append(decision)
        telemetry.counter("control.decisions").inc()
        _flightrec.record(
            kind, actuator=actuator, frm=str(frm), to=str(to_name), tick=ch.tick,
            occupancy_short=round(occ_s, 4), occupancy_long=round(occ_l, 4),
        )
        if ch.journal is not None:
            ch.journal.append(("decision", decision))

    # -------------------------------------------------------------------- reports
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def channel_report(self, engine: Any) -> Dict[str, Any]:
        """Live actuator positions + toggle counts for one engine."""
        with self._lock:
            ch = self._channel(engine)
            return {
                "mode": MODES[ch.mode_idx], "linger_ms": ch.linger_ms,
                "coalesce": ch.coalesce, "tick": ch.tick,
                "transitions": dict(ch.transitions),
                "occupancy_short": ch.occupancy(self.options.window_short),
                "occupancy_long": ch.occupancy(self.options.window_long),
            }

    def toggle_rate_ok(self, engine: Any) -> bool:
        """The decision-rate-cap invariant the stability suite pins: no actuator may
        have toggled more than once per ``min_hold_ticks`` offered batches."""
        with self._lock:
            ch = self._channel(engine)
            cap = ch.tick / max(1, self.options.min_hold_ticks) + 1
            return all(t <= cap for t in ch.transitions.values())


# ---------------------------------------------------------------------------
# adaptive replay: WAL minus the journaled sheds
# ---------------------------------------------------------------------------

def shed_seqs(control_dir: Any) -> FrozenSet[int]:
    """The WAL sequence numbers the decision journal records as shed."""
    from torchmetrics_tpu_torch.robust.journal import Journal

    jr = control_dir if hasattr(control_dir, "read") else Journal(control_dir)
    out = set()
    for _seq, args, _kwargs in jr.read():
        if args and args[0] == "shed":
            out.add(int(args[1]["seq"]))
    return frozenset(out)


def adaptive_recover(metric: Any, wal_dir: Any, control_dir: Optional[Any] = None,
                     cursor: Any = None) -> Dict[str, Any]:
    """``snapshot + replay(WAL − journaled sheds)``: bit-identical adaptive recovery.

    The controller's only effect on *values* is which offered batches shed (dwell and
    coalesce changes alter launch shape, which the scan tier's bit-identity contract
    already covers), and every shed is a decision-journal record — so replaying the
    write-ahead journal while skipping exactly those sequence numbers reconstructs
    the live adaptive state byte for byte. ``cursor`` passes through to
    :func:`~torchmetrics_tpu_torch.robust.journal.recover` (post-mortem bundle replay).
    """
    from torchmetrics_tpu_torch.robust import journal as _journal

    wal_dir = os.fspath(wal_dir)
    if control_dir is None:
        control_dir = wal_dir + CONTROL_DIR_SUFFIX
    skips = shed_seqs(control_dir) if os.path.isdir(os.fspath(control_dir)) else frozenset()
    out = _journal.recover(metric, wal_dir, cursor=cursor, skip_seqs=skips)
    out["shed_skipped"] = len(skips)
    return out


# ---------------------------------------------------------------------------
# shared drain: one thread, many engines, weighted deficit round-robin
# ---------------------------------------------------------------------------

class SharedDrain:
    """One drain thread serving many engines, scheduled by per-engine SLO burn.

    Weighted deficit round-robin: each scheduling round banks ``quantum × weight``
    credit per engine (weight = 1 + window occupancy + short-window shed burn — the
    per-engine burn proxy), and an engine spends one credit per applied window.
    A hot tenant earns proportionally more service, but every attached engine keeps
    the base quantum and banked credit is capped, so no engine starves. The thread
    participates in the same death/restart latch as per-engine drains: a dead shared
    drain is revived by the next ``ensure_alive`` (any quiesce/enqueue) with a
    flight-recorder event.
    """

    def __init__(self, quantum: float = 1.0, deficit_cap: float = 4.0,
                 name: str = "tm-tpu-torch-shared-drain") -> None:
        self.quantum = float(quantum)
        self.deficit_cap = float(deficit_cap)
        self.name = name
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._engines: List[Any] = []
        # shared-thread-only scratch: the loop is the sole reader AND writer
        self._deficit: Dict[int, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self.restarts = 0

    def attach(self, engine: Any) -> Any:
        """Adopt ``engine``: its own drain thread never starts; this one serves it."""
        with self._lock:
            if engine not in self._engines:
                self._engines.append(engine)
            engine._drain_owner = self
            n = len(self._engines)
        _flightrec.record("control.shared_drain_attach", engines=n)
        self.ensure_alive()
        self._wake.set()
        return engine

    def detach(self, engine: Any) -> None:
        with self._lock:
            if engine in self._engines:
                self._engines.remove(engine)
            if getattr(engine, "_drain_owner", None) is self:
                engine._drain_owner = None

    def is_drain_thread(self) -> bool:
        return threading.current_thread() is self._thread

    def kick(self) -> None:
        self._wake.set()

    def ensure_alive(self) -> None:
        """(Re)start the shared drain; the restart path is the thread-death latch."""
        with self._lock:
            t = self._thread
            if t is not None and t.is_alive():
                return
            if t is not None:
                self.restarts += 1
                telemetry.counter("serve.drain_restarts").inc()
                _flightrec.record(
                    "control.shared_drain_restart", restarts=self.restarts,
                    engines=len(self._engines),
                )
            self._stop = False
            self._thread = threading.Thread(target=self._loop, daemon=True, name=self.name)
            self._thread.start()

    def close(self) -> None:
        with self._lock:
            self._stop = True
            t = self._thread
        self._wake.set()
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    def _weight(self, engine: Any) -> float:
        w = 1.0 + min(1.0, engine.inflight / float(engine.options.max_inflight))
        ctrl = getattr(engine, "_control", None)
        if ctrl is not None:
            try:
                w += ctrl.shed_burn(engine)
            except ServeError:
                pass  # engine raced a detach; base weight still serves it
        return w

    def _loop(self) -> None:
        _trace.note_thread("serve-shared-drain")
        while True:
            with self._lock:
                if self._stop:
                    return
                engines = list(self._engines)
            if not engines:
                self._wake.wait(0.05)
                self._wake.clear()
                continue
            progressed = False
            for eng in engines:
                credit = min(
                    self.deficit_cap,
                    self._deficit.get(id(eng), 0.0) + self.quantum * self._weight(eng),
                )
                while credit >= 1.0:
                    outcome = eng._drain_once(wait=False)
                    if outcome == "applied":
                        credit -= 1.0
                        progressed = True
                        continue
                    if outcome == "killed":
                        # the chaos kill semantics: this thread genuinely dies; the
                        # next ensure_alive (quiesce/enqueue) revives it
                        self._deficit[id(eng)] = credit
                        return
                    if outcome == "stop":
                        credit = 0.0
                    break
                self._deficit[id(eng)] = credit
            if not progressed:
                self._wake.wait(0.005)
                self._wake.clear()


# ---------------------------------------------------------------------------
# drift-triggered auto-snapshot
# ---------------------------------------------------------------------------

class DriftSnapshotter:
    """Every detected shift gets a checkpoint to diff against.

    Subscribes to a :class:`~torchmetrics_tpu_torch.online.drift.DriftMonitor`: while the
    detectors are quiet, each :meth:`poll` refreshes a rolling host-side *pre-shift*
    snapshot; the evaluation that transitions a spec into ``drifting`` durably lands
    the pre-shift blob and an at-alarm blob (``robust.checkpoint`` format, CRC'd),
    opens an incident, records ``drift.auto_snapshot``, and captures a post-mortem
    bundle. De-escalation (the alarm clearing) re-arms the capture.
    """

    def __init__(self, metric: Any, monitor: Any, outdir: str) -> None:
        self.metric = metric
        self.monitor = monitor
        self.outdir = os.fspath(outdir)
        os.makedirs(self.outdir, exist_ok=True)
        self._healthy_blob: Optional[Dict[str, Any]] = None
        self._firing: set = set()
        self.captured: List[Dict[str, Any]] = []
        monitor.subscribe(self._on_transition)

    def poll(self, now: Optional[float] = None) -> List[Any]:
        """Evaluate the monitor (transitions fire captures via the subscription),
        then refresh the pre-shift snapshot while everything is quiet."""
        statuses = self.monitor.evaluate(now=now)
        if not self._firing:
            from torchmetrics_tpu_torch.robust import checkpoint as _checkpoint

            self._healthy_blob = _checkpoint.snapshot_metric(self.metric)
        return statuses

    def _on_transition(self, status: Any, firing: bool) -> None:
        name = status.spec.name
        if not firing:
            self._firing.discard(name)
            return
        if name in self._firing:
            return
        self._firing.add(name)
        self._capture(status)

    def _capture(self, status: Any) -> Dict[str, Any]:
        from torchmetrics_tpu_torch.robust import checkpoint as _checkpoint

        name = status.spec.name
        incident = _flightrec.open_incident(f"drift_shift.{name}")
        base = os.path.join(self.outdir, f"{name}-{len(self.captured)}")
        paths: Dict[str, str] = {}
        if self._healthy_blob is not None:
            paths["pre_shift"] = _checkpoint.save_snapshot(
                self._healthy_blob, base + "-pre.tmsnap"
            )
        paths["at_alarm"] = _checkpoint.save_snapshot(
            _checkpoint.snapshot_metric(self.metric), base + "-alarm.tmsnap"
        )
        _flightrec.record(
            "drift.auto_snapshot", name=name, incident=incident,
            score=None if status.score is None else round(float(status.score), 6),
            pre_shift="pre_shift" in paths,
        )
        telemetry.counter("control.drift_snapshots").inc()
        bundle_path = _bundle.capture_bundle(f"drift_shift.{name}", metric=self.metric)
        record = {
            "name": name, "incident": incident, "score": status.score,
            "paths": paths, "bundle": bundle_path,
        }
        self.captured.append(record)
        return record
