"""Per-ticket serve traces: span taxonomy, flow events, and the lock-light ring (counterpart of
``torchmetrics_tpu/obs/trace.py``).

Every batch entering ``update_async`` gets a **trace id** minted at enqueue and carried on its
:class:`~torchmetrics_tpu_torch.serve.engine.IngestTicket`; the engine emits one span event per
pipeline stage, under the JAX package's names, phases and ids:

==========================  ====  =======================================================
``serve.enqueue``           X     admit slice on the CALLER thread (dur = journal+admit)
``serve.ticket``            s     Perfetto flow start, bound to the enqueue slice
``serve.stage.staged``      i     staging transfer issued (args: slot)
``serve.stage.coalesced``   i     drain folded this ticket into a width-k stacked launch
``serve.stage.dispatched``  i     drain dispatched (args: tier = update|update_batches)
``serve.apply``             X     apply slice on the DRAIN thread (one per launch)
``serve.stage.committed``   i     commit (args: enqueue->commit latency_us, generation)
``serve.ticket``            f     flow end on the drain thread: the link Perfetto draws
``serve.stage.shed``        i     terminal: never admitted (no flow pair by design)
``serve.stage.failed``      i+f   terminal: apply error (flow still closes)
``serve.stage.abandoned``   i+f   terminal: chaos preemption dropped the window
``serve.stage.fence_break`` i     quiesce-contract violation observed by the drain
==========================  ====  =======================================================

The ``s``/``f`` pair shares ``id=trace_id`` and ``cat="serve"``, so ui.perfetto.dev draws an arrow
from the caller-thread enqueue slice to the drain-thread commit slice. The invariant
:func:`validate_flows` enforces: every ``s`` has exactly one ``f`` (commit, failure, or abandon),
and committed flows end on the drain track.

Events land in a **bounded ring** (:class:`TraceRing`) separate from the main telemetry log.
Everything is gated on the port's ``TM_TPU_TELEMETRY`` switch (``obs.telemetry``): with tracing
disabled, :func:`mint` returns ``None`` after one flag read and every emit hook no-ops. The events
are host Python only; no tensor is read.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Set

from torchmetrics_tpu_torch.obs.telemetry import _env_int, telemetry

ENV_TRACE_RING = "TM_TPU_TRACE_RING_EVENTS"

__all__ = [
    "TraceRing", "ring", "mint", "enqueue_span", "shed_event", "coalesced_event",
    "dispatched_event", "apply_span", "committed_event", "failed_event",
    "abandoned_event", "fence_break_event", "note_thread", "events", "clear",
    "span_count", "validate_flows",
]


class TraceRing:
    """Bounded ring of trace events.

    The deque append itself is atomic under the GIL, but the high-water counter beside it is a
    read-modify-write that the caller thread and the drain thread both execute, so the push path
    takes an uncontended ``Lock``. ``dropped`` stays exact because ``_pushed`` and the ring move
    together.
    """

    __slots__ = ("_events", "_pushed", "_lock")

    def __init__(self, maxlen: Optional[int] = None) -> None:
        self._events: deque = deque(maxlen=maxlen or _env_int(ENV_TRACE_RING, 65536))
        self._pushed = 0
        self._lock = threading.Lock()

    def push(self, evt: Dict[str, Any]) -> None:
        with self._lock:
            self._pushed += 1
            self._events.append(evt)

    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        """Events overwritten by the bound (pushed minus retained)."""
        return max(0, self._pushed - len(self._events))

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._pushed = 0


#: the process-global serve-trace ring (exported by ``obs.export_trace``)
ring = TraceRing()

_mint_id = itertools.count(1).__next__
#: thread idents that already pushed a thread_name metadata record (dedup)
_named_threads: Set[int] = set()


def clear() -> None:
    """Drop recorded serve-trace events (tests / fresh smoke runs)."""
    ring.clear()
    _named_threads.clear()


def events() -> List[Dict[str, Any]]:
    return ring.events()


def span_count() -> int:
    """Serve-trace events currently retained in the ring."""
    return len(ring)


def _tid() -> int:
    return threading.get_ident() & 0xFFFF


def _push(name: str, ph: str, ts_us: float, args: Optional[dict] = None,
          dur_us: Optional[float] = None, flow_id: Optional[int] = None) -> None:
    evt: Dict[str, Any] = {
        "name": name, "cat": "serve", "ph": ph, "ts": round(ts_us, 3),
        "pid": telemetry.pid, "tid": _tid(),
    }
    if ph == "i":
        evt["s"] = "t"
    if dur_us is not None:
        evt["dur"] = round(dur_us, 3)
    if flow_id is not None:
        evt["id"] = flow_id
    if ph == "f":
        evt["bp"] = "e"  # bind the flow end to the enclosing drain slice
    if args:
        evt["args"] = args
    ring.push(evt)
    telemetry.counter("trace.spans").inc()


def note_thread(name: str) -> None:
    """Label the calling thread's track in the exported trace (once per thread)."""
    if not telemetry.enabled:
        return
    tid = _tid()
    if tid in _named_threads:
        return
    _named_threads.add(tid)
    ring.push({
        "name": "thread_name", "ph": "M", "ts": 0, "pid": telemetry.pid, "tid": tid,
        "args": {"name": name},
    })


# ------------------------------------------------------------------ stage emitters
def mint() -> Optional[int]:
    """Mint a trace id for one ticket; None (one flag read) while tracing is disabled."""
    if not telemetry.enabled:
        return None
    telemetry.counter("trace.tickets").inc()
    return _mint_id()


def enqueue_span(trace_id: Optional[int], t0_us: float, seq: int, depth: int,
                 slot: Optional[int]) -> None:
    """Caller-thread admit slice + flow start + staged instant for one admitted ticket."""
    if trace_id is None or not telemetry.enabled:
        return
    note_thread("serve-caller")
    now = telemetry.now_us()
    args = {"seq": seq, "ticket": trace_id, "queue_depth": depth}
    _push("serve.enqueue", "X", t0_us, args=args, dur_us=now - t0_us)
    _push("serve.ticket", "s", t0_us, flow_id=trace_id)
    _push("serve.stage.staged", "i", now, args={"ticket": trace_id, "slot": slot})


def shed_event(trace_id: Optional[int], seq: int) -> None:
    """Terminal shed instant (no flow pair: a shed ticket never reaches the drain)."""
    if not telemetry.enabled:
        return
    _push("serve.stage.shed", "i", telemetry.now_us(), args={"seq": seq, "ticket": trace_id})


def coalesced_event(trace_id: Optional[int], width: int) -> None:
    if trace_id is None or not telemetry.enabled:
        return
    _push("serve.stage.coalesced", "i", telemetry.now_us(),
          args={"ticket": trace_id, "width": width})


def dispatched_event(trace_id: Optional[int], tier: str, width: int) -> None:
    if trace_id is None or not telemetry.enabled:
        return
    _push("serve.stage.dispatched", "i", telemetry.now_us(),
          args={"ticket": trace_id, "tier": tier, "width": width})


def apply_span(t0_us: float, width: int, tier: str) -> None:
    """Drain-thread apply slice covering one (possibly coalesced) launch."""
    if not telemetry.enabled:
        return
    note_thread("serve-drain")
    _push("serve.apply", "X", t0_us, args={"width": width, "tier": tier},
          dur_us=telemetry.now_us() - t0_us)


def committed_event(trace_id: Optional[int], latency_us: float,
                    generation: Optional[int]) -> None:
    """Commit instant + flow end on the drain track — resolves the enqueue flow."""
    if trace_id is None or not telemetry.enabled:
        return
    note_thread("serve-drain")
    now = telemetry.now_us()
    _push("serve.stage.committed", "i", now,
          args={"ticket": trace_id, "latency_us": round(latency_us, 1),
                "generation": generation})
    _push("serve.ticket", "f", now, flow_id=trace_id)


def failed_event(trace_id: Optional[int], error: str) -> None:
    """Terminal apply-failure instant; the flow still closes (no dangling ``s``)."""
    if trace_id is None or not telemetry.enabled:
        return
    now = telemetry.now_us()
    _push("serve.stage.failed", "i", now, args={"ticket": trace_id, "error": error[:200]})
    _push("serve.ticket", "f", now, flow_id=trace_id)


def abandoned_event(trace_id: Optional[int]) -> None:
    """Terminal chaos-preemption close for a ticket dropped with the window."""
    if trace_id is None or not telemetry.enabled:
        return
    now = telemetry.now_us()
    _push("serve.stage.abandoned", "i", now, args={"ticket": trace_id})
    _push("serve.ticket", "f", now, flow_id=trace_id)


def fence_break_event(expected: Optional[int], observed: Optional[int]) -> None:
    if not telemetry.enabled:
        return
    _push("serve.stage.fence_break", "i", telemetry.now_us(),
          args={"expected_generation": expected, "observed_generation": observed})


# ------------------------------------------------------------------ flow validation
def validate_flows(trace_events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Check the Perfetto flow-event contract over an exported event list.

    Valid iff every ``ph:"s"`` has exactly one matching ``ph:"f"`` (same id, cat
    ``serve``), ids are unique per ticket, and every *committed* ticket's flow ends on
    a different thread track than it started (the caller→drain link). Returns the
    evidence dict the smoke/chaos assertions consume.
    """
    starts: Dict[int, Dict[str, Any]] = {}
    ends: Dict[int, List[Dict[str, Any]]] = {}
    committed: Set[int] = set()
    for e in trace_events:
        if e.get("cat") != "serve":
            continue
        if e.get("ph") == "s":
            if e["id"] in starts:
                return {"valid": False, "reason": f"duplicate flow start id {e['id']}"}
            starts[e["id"]] = e
        elif e.get("ph") == "f":
            ends.setdefault(e["id"], []).append(e)
        elif e.get("name") == "serve.stage.committed":
            committed.add(e.get("args", {}).get("ticket"))
    dangling = [i for i in starts if i not in ends]
    doubled = [i for i, es in ends.items() if len(es) > 1]
    orphan_f = [i for i in ends if i not in starts]
    cross_thread = [
        i for i in committed
        if i in starts and i in ends and ends[i][0]["tid"] != starts[i]["tid"]
    ]
    valid = not dangling and not doubled and not orphan_f and (
        len(cross_thread) == len([i for i in committed if i in starts])
    )
    return {
        "valid": bool(valid),
        "flows": len(starts),
        "committed_flows": len(committed & set(starts)),
        "committed_cross_thread": len(cross_thread),
        "dangling_starts": dangling[:8],
        "orphan_ends": orphan_f[:8],
        "doubled_ends": doubled[:8],
    }
