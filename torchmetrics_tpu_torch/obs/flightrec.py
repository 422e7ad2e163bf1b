"""Always-on flight recorder: a bounded, lock-light ring of notable engine events (counterpart of
``torchmetrics_tpu/obs/flightrec.py``).

Every failure seam records one small host-side event here, **unconditionally**: unlike the trace
log of :mod:`~torchmetrics_tpu_torch.obs.telemetry` this is not gated on ``TM_TPU_TELEMETRY``,
because the events it holds are the rare, load-bearing ones, not per-step volume. The record
path holds no tensor: a dict of host scalars, one lock acquire, one deque append.

Event kinds the port records so far:

==========================  ==========================================================
``jit.recompile_churn``     the one-shot capture-churn warning fired
``slo.alarm``               an SLO or drift burn alarm transitioned (both ways)
``incident.opened``         a seam minted a new incident id
``incident.adopted``        this process joined an incident another process opened
==========================  ==========================================================

Cost model: :func:`record` builds one small dict, then, under one uncontended per-instance
``Lock``, stamps a monotonic sequence number and a microsecond timestamp and appends to a
bounded ``deque``, and bumps the always-on ``flight.events`` counter. The lock makes ring order
equal sequence order per recorder.

    >>> import torchmetrics_tpu_torch.obs.flightrec as flightrec
    >>> flightrec.clear()
    >>> _ = flightrec.record("sync.downgrade", level="quorum", states=("v",))
    >>> evts = flightrec.events()
    >>> evts[-1]["kind"], evts[-1]["level"]
    ('sync.downgrade', 'quorum')
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Any, Dict, List, Optional

from torchmetrics_tpu_torch.obs.telemetry import _env_int, telemetry

ENV_FLIGHT_EVENTS = "TM_TPU_FLIGHT_EVENTS"
#: seconds within which a new seam JOINS the active incident instead of minting a fresh id: one
#: failure cascading through several seams is ONE incident
ENV_INCIDENT_WINDOW = "TM_TPU_INCIDENT_WINDOW_S"
_DEFAULT_INCIDENT_WINDOW_S = 300

#: bound once: the global registry instance is never replaced (reset() mutates it in place)
_now_us = telemetry.now_us

__all__ = [
    "FlightRecorder", "recorder", "record", "events", "clear", "snapshot", "last_seq",
    "open_incident", "adopt_incident", "current_incident", "recent_incidents", "clear_incidents",
]


class FlightRecorder:
    """Bounded always-on event ring with monotonic per-process sequence numbers.

    The record path takes a per-instance ``Lock`` around the sequence draw, the high-water
    cursor and the append, so the ring order IS the sequence order and ``last_seq`` never
    regresses under concurrent recorders. The sequence counter itself is process-wide, so that
    merged views order events from several recorders. ``dropped`` counts the events the bound
    overwrote.
    """

    __slots__ = ("_events", "_pushed", "_seq", "_lock")

    #: process-wide monotonic sequence (shared so merged views order correctly)
    _next_seq = itertools.count(1).__next__

    def __init__(self, maxlen: Optional[int] = None) -> None:
        self._events: deque = deque(maxlen=maxlen or _env_int(ENV_FLIGHT_EVENTS, 4096))
        self._pushed = 0
        self._seq = 0  # highest sequence this recorder has seen
        self._lock = threading.Lock()

    def record(self, kind: str, **fields: Any) -> int:
        """Append one event; returns its sequence number. Always-on."""
        evt: Dict[str, Any] = {"kind": kind}
        # while an incident is open, every flight event carries its id
        inc = _active_incident
        if inc is not None and "incident" not in fields:
            evt["incident"] = inc["id"]
        if fields:
            evt.update(fields)
        with self._lock:
            seq = FlightRecorder._next_seq()
            evt["seq"] = seq
            evt["ts_us"] = round(_now_us(), 1)
            self._pushed += 1
            self._seq = seq
            self._events.append(evt)
        telemetry.counter("flight.events").inc()
        return seq

    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        """Events overwritten by the bound (pushed minus retained)."""
        return max(0, self._pushed - len(self._events))

    @property
    def last_seq(self) -> int:
        """Sequence number of the most recent event this recorder saw (0 = none)."""
        return self._seq

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serialisable view, events ordered by sequence number (the sort keeps merged views
        of several recorders sharing the process-wide counter in causal order)."""
        with self._lock:
            events = list(self._events)
            pushed = self._pushed
            seq = self._seq
        return {
            "events": sorted(events, key=lambda e: e["seq"]),
            "recorded": pushed,
            "dropped": max(0, pushed - len(events)),
            "last_seq": seq,
            "maxlen": self._events.maxlen,
        }

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._pushed = 0
            self._seq = 0


#: the process-global flight ring every seam records into
recorder = FlightRecorder()

# the process-global record path IS the method, not a wrapper around it: no second call frame
# per event (the recorder is never rebound)
record = recorder.record


def events() -> List[Dict[str, Any]]:
    return recorder.events()


def last_seq() -> int:
    return recorder.last_seq


def snapshot() -> Dict[str, Any]:
    return recorder.snapshot()


def clear() -> None:
    """Drop recorded events (tests, fresh smoke runs)."""
    recorder.clear()


# ---------------------------------------------------------------- incident correlation
# One INCIDENT groups every flight event that a single failure produced: the first seam mints a
# process-stable id, later seams inside the window JOIN it.

_incident_seq = itertools.count(1).__next__
_active_incident: Optional[Dict[str, Any]] = None
#: recently opened/adopted incidents, newest last
_recent_incidents: deque = deque(maxlen=16)


def _incident_window_s() -> float:
    return float(_env_int(ENV_INCIDENT_WINDOW, _DEFAULT_INCIDENT_WINDOW_S))


def current_incident() -> Optional[str]:
    """Id of the open incident (None when no seam fired inside the window)."""
    inc = _active_incident
    if inc is None:
        return None
    if (telemetry.now_us() - inc["opened_us"]) > _incident_window_s() * 1e6:
        return None  # the incident aged out; the next seam mints a fresh id
    return inc["id"]


def open_incident(reason: str) -> str:
    """Mint (or join) the process-stable incident id for a seam.

    Within ``TM_TPU_INCIDENT_WINDOW_S`` (default 300 s) of the first seam, every later seam
    returns the SAME id. The id embeds the process fingerprint, so ids from restarted processes
    never collide even at equal pids.
    """
    global _active_incident
    existing = current_incident()
    if existing is not None:
        return existing
    from torchmetrics_tpu_torch.obs.telemetry import process_fingerprint

    inc_id = f"inc-{process_fingerprint()['fingerprint']}-{_incident_seq():04d}"
    inc = {"id": inc_id, "reason": str(reason), "opened_us": round(telemetry.now_us(), 1), "rank": None}
    _active_incident = inc
    _recent_incidents.append(dict(inc))
    telemetry.counter("flight.incidents").inc()
    # recorded AFTER _active_incident is set, so the opening event itself carries the id
    recorder.record("incident.opened", id=inc_id, reason=str(reason))
    return inc_id


def adopt_incident(incident_id: str, reason: str = "adopted") -> str:
    """Join an incident another process opened: later events here share the foreign id."""
    global _active_incident
    if current_incident() == incident_id:
        return incident_id
    inc = {"id": str(incident_id), "reason": str(reason), "opened_us": round(telemetry.now_us(), 1), "adopted": True}
    _active_incident = inc
    _recent_incidents.append(dict(inc))
    telemetry.counter("flight.incidents_adopted").inc()
    recorder.record("incident.adopted", id=str(incident_id), reason=str(reason))
    return str(incident_id)


def recent_incidents() -> List[Dict[str, Any]]:
    """Recently opened/adopted incidents (newest last)."""
    return [dict(i) for i in _recent_incidents]


def clear_incidents() -> None:
    """Forget the active and recent incidents (tests, fresh smoke runs)."""
    global _active_incident
    _active_incident = None
    _recent_incidents.clear()
