"""Process-global telemetry registry: counters, timers, histograms, gauges, live series and a
trace-event log (counterpart of ``torchmetrics_tpu/obs/telemetry.py``).

Stdlib only at import time; ``torch`` is touched lazily, for the pytree leaves of
:func:`describe_abstract` / :func:`tree_bytes` and for :func:`device_sync`. Two cost tiers, as in
the JAX package:

- **counting**: plain integer bumps (per-metric dicts and registry :class:`Counter` objects).
  Always on: a bump is about 100 ns of host Python, next to a step's graph replay.
- **tracing**: wall-clock spans, the event log and timers. Gated on the global enabled flag
  (:func:`enable`, the ``TM_TPU_TELEMETRY`` environment variable, the :func:`enabled` context
  manager); while disabled every tracing entry point returns through a shared null scope that
  allocates nothing.

Everything here is host-side Python. No hook reads a device value or launches device work, so
the engine's hooks sit outside every captured CUDA graph and leave a graph step's host
operations as they were.

The port's counterpart of a jit trace is a **graph capture** (``ops/dispatch.py`` captures once
per step kind and input signature): :func:`record_trace` is called at each capture with the step
kind, so ``traces.<kind>`` counts captures and a second capture of one kind on a new signature is
a retrace. The eager tier captures nothing and records no trace.

    >>> from torchmetrics_tpu_torch import obs
    >>> with obs.enabled():
    ...     with obs.telemetry.span("demo.work", cat="demo"):
    ...         pass
    >>> any(e["name"] == "demo.work" for e in obs.telemetry.events())
    True

The event log stores Chrome ``trace_event``-shaped dicts (``name``/``cat``/``ph``/``ts``/``pid``/
``tid``[/``dur``/``args``]).
"""
from __future__ import annotations

import functools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional

from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

ENV_FLAG = "TM_TPU_TELEMETRY"
ENV_RETRACE_THRESHOLD = "TM_TPU_RETRACE_WARN_THRESHOLD"
ENV_MAX_EVENTS = "TM_TPU_TELEMETRY_MAX_EVENTS"
_TRUTHY = ("1", "true", "yes", "on")


def _env_enabled(environ: Optional[Dict[str, str]] = None) -> bool:
    env = os.environ if environ is None else environ
    return str(env.get(ENV_FLAG, "")).strip().lower() in _TRUTHY


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


# --------------------------------------------------------------------------- instruments
class Counter:
    """Monotonic event count. Thread-safe; cheap enough to stay always-on."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Timer:
    """Accumulated wall time and call count of one instrumented operation."""

    __slots__ = ("name", "_count", "_total_s", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._count = 0
        self._total_s = 0.0
        self._lock = threading.Lock()

    def observe(self, dt_s: float) -> None:
        with self._lock:
            self._count += 1
            self._total_s += dt_s

    @property
    def count(self) -> int:
        return self._count

    @property
    def total_s(self) -> float:
        return self._total_s

    @property
    def mean_s(self) -> float:
        return self._total_s / self._count if self._count else 0.0


class Gauge:
    """Last-written instantaneous value (queue depth, burn rate). Thread-safe."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Bounded reservoir of raw observations with nearest-rank percentiles: the most recent
    ``maxlen`` samples, enough for p50/p99 of a latency distribution without unbounded growth."""

    __slots__ = ("name", "_values", "_count", "_lock")

    def __init__(self, name: str, maxlen: int = 4096) -> None:
        self.name = name
        self._values: deque = deque(maxlen=maxlen)
        self._count = 0
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        with self._lock:
            self._values.append(float(value))
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank percentile over the retained reservoir; None when empty."""
        with self._lock:
            vals = sorted(self._values)
        if not vals:
            return None
        rank = max(0, min(len(vals) - 1, int(round(p / 100.0 * (len(vals) - 1)))))
        return vals[rank]

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            vals = sorted(self._values)
        if not vals:
            return {"count": self._count}
        n = len(vals)

        def at(p: float) -> float:
            return vals[max(0, min(n - 1, int(round(p / 100.0 * (n - 1)))))]

        return {"count": self._count, "min": vals[0], "p50": at(50), "p90": at(90), "p99": at(99), "max": vals[-1]}


# ------------------------------------------------------------------------------ registry
class _NullScope:
    """Disabled-mode span: a shared singleton, so the fast path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL_SCOPE = _NullScope()


class _Span:
    """Wall-clock scope recorded as one complete ('X') trace event and a Timer observation."""

    __slots__ = ("_tel", "name", "cat", "args", "owner", "op", "_t0")

    def __init__(self, tel: "Telemetry", name: str, cat: str, args: Optional[dict],
                 owner: Any = None, op: Optional[str] = None) -> None:
        self._tel = tel
        self.name = name
        self.cat = cat
        self.args = args
        self.owner = owner
        self.op = op
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = time.perf_counter()
        dur_s = t1 - self._t0
        tel = self._tel
        tel.timer(self.name).observe(dur_s)
        tel.event(self.name, ph="X", cat=self.cat, ts_us=(self._t0 - tel._epoch) * 1e6, dur_us=dur_s * 1e6,
                  args=self.args)
        if self.owner is not None and self.op is not None:
            times = self.owner.__dict__.setdefault("_tm_times", {})
            times[self.op] = times.get(self.op, 0.0) + dur_s
        return False


class Telemetry:
    """Registry of named instruments plus a bounded trace-event log.

    One process-global instance lives at :data:`telemetry`; fresh instances are cheap and handy
    for tests. ``device`` is where the live series created through this registry keep their
    sketch: the card unless the caller names another (resolved at a series' first fold).

        >>> t = Telemetry()
        >>> t.counter("x").inc(2)
        >>> t.counter("x").value
        2
        >>> t.event("ignored-while-disabled")
        >>> len(t.events())
        0
    """

    def __init__(self, enabled: Optional[bool] = None, max_events: Optional[int] = None,
                 device: Any = None) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._timers: Dict[str, Timer] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._series: Dict[str, Any] = {}  # name -> obs.timeseries.TimeSeries
        self._events: deque = deque(maxlen=max_events or _env_int(ENV_MAX_EVENTS, 200_000))
        self._dropped_events = 0
        self._epoch = time.perf_counter()
        self._pid = os.getpid()
        self.device = device
        self.enabled = _env_enabled() if enabled is None else enabled

    # -- instrument access (get-or-create, thread-safe) ---------------------------------
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def timer(self, name: str) -> Timer:
        t = self._timers.get(name)
        if t is None:
            with self._lock:
                t = self._timers.setdefault(name, Timer(name))
        return t

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name))
        return h

    def get_histogram(self, name: str) -> Optional[Histogram]:
        return self._histograms.get(name)

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def series(self, name: str, **kwargs: Any) -> Any:
        """Get-or-create the named live :class:`~torchmetrics_tpu_torch.obs.timeseries.TimeSeries`
        (always-on, O(1) memory; ``kwargs`` shape it on first creation, and its device defaults to
        this registry's)."""
        s = self._series.get(name)
        if s is None:
            from torchmetrics_tpu_torch.obs.timeseries import TimeSeries

            kwargs.setdefault("device", self.device)
            with self._lock:
                s = self._series.get(name)
                if s is None:
                    s = self._series[name] = TimeSeries(name, **kwargs)
        return s

    def get_series(self, name: str) -> Optional[Any]:
        return self._series.get(name)

    def series_names(self) -> List[str]:
        return sorted(self._series)

    # -- event log ----------------------------------------------------------------------
    def now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def event(
        self,
        name: str,
        ph: str = "i",
        cat: str = "tm",
        ts_us: Optional[float] = None,
        dur_us: Optional[float] = None,
        args: Optional[dict] = None,
        tid: Optional[int] = None,
    ) -> None:
        """Append one Chrome trace_event-shaped record (no-op while disabled)."""
        if not self.enabled:
            return
        evt: Dict[str, Any] = {
            "name": name,
            "cat": cat,
            "ph": ph,
            "ts": round(self.now_us() if ts_us is None else ts_us, 3),
            "pid": self._pid,
            "tid": threading.get_ident() & 0xFFFF if tid is None else tid,
        }
        if ph == "i":
            evt["s"] = "t"  # thread-scoped instant
        if dur_us is not None:
            evt["dur"] = round(dur_us, 3)
        if args:
            evt["args"] = args
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self._dropped_events += 1
            self._events.append(evt)

    def span(self, name: str, cat: str = "tm", args: Optional[dict] = None):
        """Timed scope: one 'X' event and a Timer observation; the null scope while disabled."""
        if not self.enabled:
            return _NULL_SCOPE
        return _Span(self, name, cat, args)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    @property
    def dropped_events(self) -> int:
        return self._dropped_events

    @property
    def pid(self) -> int:
        return self._pid

    # -- lifecycle ----------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time view of every instrument (JSON-serialisable)."""
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            timers = {
                n: {"count": t.count, "total_s": round(t.total_s, 6), "mean_s": round(t.mean_s, 9)}
                for n, t in self._timers.items()
            }
            hists = {n: h.summary() for n, h in self._histograms.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            series_objs = dict(self._series)
            n_events = len(self._events)
        # series summaries outside the registry lock: a quantile read copies a sketch from the
        # device, and must not hold up concurrent instrument creation
        series = {n: s.summary() for n, s in series_objs.items()}
        return {
            "enabled": self.enabled,
            "counters": counters,
            "timers": timers,
            "histograms": hists,
            "gauges": gauges,
            "series": series,
            "events_recorded": n_events,
            "events_dropped": self._dropped_events,
        }

    def reset(self, clear_events: bool = True) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()
            self._histograms.clear()
            self._gauges.clear()
            self._series.clear()
            if clear_events:
                self._events.clear()
                self._dropped_events = 0


#: The process-global registry every built-in hook records into.
telemetry = Telemetry()


def is_enabled() -> bool:
    return telemetry.enabled


def enable() -> None:
    telemetry.enabled = True


def disable() -> None:
    telemetry.enabled = False


@contextmanager
def enabled(flag: bool = True) -> Iterator[Telemetry]:
    """Scoped activation: ``with obs.enabled(): ...`` (restores the prior state on exit)."""
    prev = telemetry.enabled
    telemetry.enabled = flag
    try:
        yield telemetry
    finally:
        telemetry.enabled = prev


# ------------------------------------------------------------------- engine-facing hooks
def bump(owner: Any, key: str, n: int = 1) -> None:
    """Increment a per-instance counter dict on ``owner`` (lazily created, always-on)."""
    counts = owner.__dict__.get("_tm_counts")
    if counts is None:
        counts = {}
        object.__setattr__(owner, "_tm_counts", counts)
    counts[key] = counts.get(key, 0) + n


def count_dispatch(owner: Any, n: int = 1) -> None:
    """Record ``n`` device steps (a graph replay, or an eager step) attributed to ``owner``."""
    bump(owner, "dispatches", n)
    telemetry.counter("engine.dispatches").inc(n)


def metric_span(owner: Any, op: str):
    """Timed scope for one metric operation; the null scope while tracing is disabled.

    Records a ``metric.{Class}.{op}`` complete event and timer observation, and accumulates
    per-instance wall time (surfaced by ``Metric.telemetry``).
    """
    if not telemetry.enabled:
        return _NULL_SCOPE
    name = f"{type(owner).__name__}.{op}"
    return _Span(telemetry, f"metric.{name}", "metric", None, owner=owner, op=op)


# ------------------------------------------------------------------- retrace detection
_retrace_warn_threshold = _env_int(ENV_RETRACE_THRESHOLD, 3)


def retrace_warn_threshold() -> int:
    return _retrace_warn_threshold


def set_retrace_warn_threshold(n: int) -> None:
    """Recaptures per step kind above which the one-shot capture-churn warning fires."""
    global _retrace_warn_threshold
    _retrace_warn_threshold = int(n)


def _leaves(trees: Any) -> list:
    from torch.utils._pytree import tree_leaves

    return tree_leaves(trees)


def _dtype_code(dtype: Any) -> Optional[tuple]:
    """``(kind, bits)`` of a numpy or torch dtype, as numpy's ``dtype.kind`` and item size."""
    import numpy as np
    import torch

    if isinstance(dtype, torch.dtype):
        if dtype == torch.bool:
            kind = "b"
        elif dtype.is_complex:
            kind = "c"
        elif dtype.is_floating_point:
            kind = "f"
        else:
            kind = "u" if dtype in (torch.uint8, getattr(torch, "uint16", None), getattr(torch, "uint32", None),
                                    getattr(torch, "uint64", None)) else "i"
        return kind, dtype.itemsize * 8
    try:
        d = np.dtype(dtype)
    except TypeError:
        return None
    return d.kind, d.itemsize * 8


def describe_abstract(*trees: Any) -> str:
    """Compact dtype/shape signature of a pytree of tensors and arrays, in the JAX package's form
    (``f32[4,2];i32[]``): the capture-key surrogate logged at every capture."""
    parts = []
    for leaf in _leaves(trees):
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is None or dtype is None:
            parts.append(type(leaf).__name__)
            continue
        code = _dtype_code(dtype)
        dims = ",".join(str(s) for s in shape)
        parts.append(f"{code[0]}{code[1]}[{dims}]" if code is not None else f"{dtype}[{dims}]")
    return ";".join(parts)


def record_trace(owner: Any, kind: str, args: tuple, kwargs: dict, fn: Optional[Callable] = None) -> None:
    """Record one graph capture of ``owner``'s ``kind`` step.

    Called once per capture, so ``traces.<kind>`` counts captures and every capture of a kind
    after its first is a recapture on a new signature (a retrace). Counting is always-on; the
    capture-key event needs tracing enabled; the churn warning is one-shot per instance. ``fn``
    is accepted for the JAX package's signature; the cost profiler it feeds is not ported.
    """
    counts = owner.__dict__.get("_tm_counts")
    if counts is None:
        counts = {}
        object.__setattr__(owner, "_tm_counts", counts)
    key = f"traces.{kind}"
    counts[key] = counts.get(key, 0) + 1
    cls = type(owner).__name__
    telemetry.counter(f"jit.trace.{cls}.{kind}").inc()
    if counts[key] > 1:
        # instance-accurate: the class-level counter alone cannot tell "two instances captured
        # once each" from "one instance captured twice"
        telemetry.counter(f"jit.retrace.{cls}.{kind}").inc()
    sig = describe_abstract(args, kwargs)
    if telemetry.enabled:
        telemetry.event(f"jit.trace.{cls}.{kind}", ph="i", cat="jit",
                        args={"cache_key": sig, "trace_index": counts[key]})
    retraces = counts[key] - 1
    if retraces > _retrace_warn_threshold and not owner.__dict__.get("_tm_retrace_warned", False):
        object.__setattr__(owner, "_tm_retrace_warned", True)
        from torchmetrics_tpu_torch.obs import flightrec as _flightrec

        _flightrec.record("jit.recompile_churn", metric=cls, kernel=kind, retraces=retraces, cache_key=sig)
        rank_zero_warn(
            f"Metric {cls} recaptured its {kind!r} CUDA graph {retraces} times (threshold"
            f" {_retrace_warn_threshold}): capture churn, usually shape/dtype-polymorphic inputs or"
            " non-tensor arguments that change value. Each new input signature captures a graph of"
            " its own. Pad batches to a fixed shape, keep config arguments constant, or raise the"
            f" threshold via obs.set_retrace_warn_threshold / ${ENV_RETRACE_THRESHOLD}."
            f" Latest cache key: {sig}",
            UserWarning,
        )


def instrument_trace(fn: Callable, owner: Any, kind: str) -> Callable:
    """Wrap a to-be-captured callable so that every call of it records a trace (for code that
    captures a body itself; the engine's captures call :func:`record_trace` directly)."""

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any):
        record_trace(owner, kind, args, kwargs, fn=fn)
        return fn(*args, **kwargs)

    return wrapper


# ------------------------------------------------------------------ process fingerprint
#: wall-clock start of this interpreter, read once at import
_START_UNIX = time.time()


@functools.lru_cache(maxsize=1)
def process_fingerprint() -> Dict[str, Any]:
    """Stable identity of THIS interpreter: host, pid, process index, start time.

    The process index is ``torch.distributed.get_rank()`` when a process group is initialised,
    else 0. The ``fingerprint`` field is an 8-hex digest of the tuple, unique across restarts
    even at equal pids.

        >>> fp = process_fingerprint()
        >>> sorted(fp) == ['fingerprint', 'host', 'pid', 'process_index', 'start_unix']
        True
        >>> len(fp['fingerprint'])
        8
    """
    import hashlib
    import socket

    host = socket.gethostname()
    pid = os.getpid()
    process_index = 0
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            process_index = int(dist.get_rank())
    except Exception:  # noqa: BLE001 - an identity probe must never fail its caller
        process_index = 0
    raw = f"{host}|{pid}|{process_index}|{_START_UNIX:.6f}".encode()
    return {
        "host": host,
        "pid": pid,
        "process_index": process_index,
        "start_unix": round(_START_UNIX, 3),
        "fingerprint": hashlib.sha1(raw).hexdigest()[:8],
    }


# ----------------------------------------------------------------------------- helpers
def tree_bytes(tree: Any) -> int:
    """Total byte size of every tensor- or array-like leaf of a pytree (shape and dtype only)."""
    total = 0
    for leaf in _leaves(tree):
        shape = getattr(leaf, "shape", None)
        dtype = getattr(leaf, "dtype", None)
        if shape is None or dtype is None:
            continue
        code = _dtype_code(dtype)
        if code is None:
            continue
        n = 1
        for s in shape:
            n *= int(s)
        total += n * code[1] // 8
    return total


def device_sync(x: Any) -> Any:
    """Wait for the card to finish the work behind ``x`` (``torch.cuda.synchronize`` of the
    device of each CUDA tensor leaf), counted as ``host.block_until_ready`` and, when tracing is
    on, recorded as a span: for a caller whose protocol needs the wait."""
    import torch

    def block() -> Any:
        devices = {leaf.device for leaf in _leaves(x) if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda"}
        for device in devices:
            torch.cuda.synchronize(device)
        return x

    telemetry.counter("host.block_until_ready").inc()
    if not telemetry.enabled:
        return block()
    with telemetry.span("host.block_until_ready", cat="host"):
        return block()
