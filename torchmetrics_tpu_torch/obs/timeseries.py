"""Always-on O(1) live time series: a bounded point ring plus KLL sketch quantiles (counterpart of
``torchmetrics_tpu/obs/timeseries.py``).

A :class:`TimeSeries` holds two fixed-size structures:

- a **point ring** of the most recent ``(monotonic_ts, value)`` pairs: the windowed view
  (:meth:`window`, :meth:`rate_over`, :meth:`bad_fraction_over`) the SLO burn-rate monitor reads;
- a **KLL quantile sketch** (the port's own ``sketch/kll.py``) fed in batches of ``fold_every``
  samples: all-time quantiles with the sketch's rank-error bound, in a fixed footprint.

Cost model: :meth:`record` is a deque append and a list append under the series' lock, with no
tensor; the fold runs once per ``fold_every`` records. The sketch lives on an explicit device,
the card unless the caller names another; ``device=None`` resolves at the first fold, so that
recording host points never needs a card. On the card the full-size fold is one captured CUDA
graph per (capacity, levels, ``fold_every``), shared by every series of that geometry; the odd
remainders that :meth:`flush` folds run eagerly. Reads merge the sketch's weighted support with
the pending raw samples on the host, after one copy of the support from the device.

    >>> ts = TimeSeries("demo", fold_every=8, device="cpu")
    >>> for v in range(100):
    ...     ts.record(float(v), now=float(v))
    >>> ts.count
    100
    >>> abs(ts.quantile(0.5) - 49.0) <= 5.0
    True
    >>> len(ts.window(9.5, now=99.0))  # points with ts > 89.5
    10
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["TimeSeries", "DEFAULT_POINTS", "DEFAULT_FOLD_EVERY", "merged_quantiles"]

#: point-ring length: minutes of serving signals at typical record rates, windowed scans O(hundreds)
DEFAULT_POINTS = 2048
#: pending samples folded into the KLL sketch per fold
DEFAULT_FOLD_EVERY = 1024

#: compact sketch geometry for telemetry series (about 4.6 KB against the metric default's 12 KB)
_SERIES_CAPACITY = 64
_SERIES_LEVELS = 18


class TimeSeriesFold:
    """Owner of the full-size folds' captured graphs: one per sketch geometry, fold size and
    device, shared by every series (the JAX package compiles ``kll_update`` once per geometry,
    ``timeseries.py:56-69``). A module-level lock serialises the shared static inputs."""

    def __init__(self) -> None:
        from torchmetrics_tpu_torch.ops.dispatch import GraphCache

        self.graphs = GraphCache()
        self.lock = threading.Lock()


_FOLD: Optional[TimeSeriesFold] = None


def _full_fold(state: Any, values: Any) -> Any:
    """``kll_update(state, values)`` for a full ``fold_every`` batch: a graph replay on the card
    (eager where the graph tier is off or the device is the CPU)."""
    global _FOLD
    from torchmetrics_tpu_torch.ops import dispatch
    from torchmetrics_tpu_torch.sketch.kll import kll_update

    if not (dispatch.fast_dispatch_enabled() and dispatch.graph_device(state.device)):
        return kll_update(state, values)
    if _FOLD is None:
        _FOLD = TimeSeriesFold()

    def build(s_args: tuple, s_kwargs: dict):
        # the state is a static input, like the batch: the graph holds no state of its own
        return (lambda: (kll_update(*s_args), {})), (lambda new_state: None)

    with _FOLD.lock:
        key = ("kll_fold", dispatch.signature((state, values), {}))
        out = _FOLD.graphs.run(_FOLD, "kll_fold", key, state.device, (state, values), {}, build)
    return kll_update(state, values) if out is dispatch.MISS else out


def _host_points(sketch: Any) -> Tuple[np.ndarray, np.ndarray]:
    """A KLL sketch's weighted support as float64 host arrays, in one copy from the device."""
    import torch

    from torchmetrics_tpu_torch.sketch.kll import kll_weighted_points

    v, w = kll_weighted_points(sketch)
    both = torch.stack([v, w]).cpu().numpy().astype(np.float64)
    return both[0], both[1]


def _rank_query(values: np.ndarray, weights: np.ndarray, qs: Sequence[float]) -> List[Optional[float]]:
    """The cumulative-weight rank query of ``kll_quantiles`` over host points."""
    order = np.argsort(values, kind="stable")
    values, weights = values[order], weights[order]
    cw = np.cumsum(weights)
    n = cw[-1] if len(cw) else 0.0
    if n <= 0:
        return [None] * len(qs)
    out: List[Optional[float]] = []
    for q in qs:
        target = min(max(float(q), 0.0), 1.0) * n
        idx = min(int(np.searchsorted(cw, target, side="left")), len(values) - 1)
        out.append(float(values[idx]))
    return out


class TimeSeries:
    """One named live series: bounded recent points and a streaming quantile sketch.

    Thread-safe for concurrent :meth:`record` calls. ``fold_every`` trades the per-record
    amortised cost against read latency; both ends stay O(1) in memory. ``device`` is where the
    sketch lives: the card unless the caller names another, resolved at the first fold.
    """

    __slots__ = (
        "name", "_points", "_pending", "_fold_every", "_sketch", "_count", "_last",
        "_total", "_lock", "_fold_lock", "_capacity", "_levels", "_device",
    )

    def __init__(
        self,
        name: str,
        points: int = DEFAULT_POINTS,
        fold_every: int = DEFAULT_FOLD_EVERY,
        capacity: int = _SERIES_CAPACITY,
        levels: int = _SERIES_LEVELS,
        device: Any = None,
    ) -> None:
        self.name = name
        self._points: deque = deque(maxlen=max(8, int(points)))
        self._pending: List[float] = []
        self._fold_every = max(1, int(fold_every))
        self._sketch: Optional[Any] = None  # lazy: no tensor until the first fold
        self._count = 0
        self._last: Optional[float] = None
        self._total = 0.0
        self._lock = threading.Lock()
        self._fold_lock = threading.Lock()  # serialises the sketch's read-modify-write
        self._capacity = capacity
        self._levels = levels
        self._device = device

    # ------------------------------------------------------------------ hot path
    def record(self, value: float, now: Optional[float] = None) -> None:
        """Append one observation; the sketch fold is batched."""
        value = float(value)
        t = time.monotonic() if now is None else now
        batch: Optional[List[float]] = None
        with self._lock:
            self._points.append((t, value))
            self._pending.append(value)
            self._count += 1
            self._last = value
            self._total += value
            if len(self._pending) >= self._fold_every:
                batch, self._pending = self._pending, []
        if batch is not None:
            self._fold(batch)

    @property
    def device(self) -> Any:
        """The sketch's device: the one given, else the card, resolved at the first fold."""
        if self._device is None or not hasattr(self._device, "type"):
            from torchmetrics_tpu_torch.metric import resolve_device

            self._device = resolve_device(self._device)
        return self._device

    def _fold(self, batch: Sequence[float]) -> None:
        """Fold one swapped-out pending batch into the sketch, off the record lock: a full batch
        through the shared captured fold, an odd remainder eagerly."""
        import torch

        from torchmetrics_tpu_torch.sketch.kll import kll_init, kll_update

        device = self.device
        values = torch.tensor(batch, dtype=torch.float32).to(device)
        with self._fold_lock:
            state = self._sketch
            if state is None:
                state = kll_init(self._capacity, self._levels).to(device)
            if len(batch) == self._fold_every:
                self._sketch = _full_fold(state, values)
            else:
                self._sketch = kll_update(state, values)

    # ----------------------------------------------------------------- accessors
    @property
    def count(self) -> int:
        """Total observations ever recorded (exact: folds conserve weight)."""
        return self._count

    @property
    def last(self) -> Optional[float]:
        return self._last

    @property
    def total(self) -> float:
        """Running sum of every recorded value."""
        return self._total

    @property
    def sketch(self) -> Optional[Any]:
        """The folded KLL sketch on its device (None before the first fold); a read, not a copy."""
        return self._sketch

    def flush(self) -> None:
        """Force-fold any pending samples into the sketch."""
        with self._lock:
            batch, self._pending = self._pending, []
        if batch:
            self._fold(batch)

    def quantile(self, q: float) -> Optional[float]:
        """All-time quantile estimate from the sketch and the pending samples; None before any."""
        return None if self._count == 0 else self.quantiles((q,))[0]

    def quantiles(self, qs: Sequence[float]) -> List[Optional[float]]:
        """All-time quantiles over sketch and pending samples, WITHOUT folding on the read path:
        the sketch's weighted support merges with the raw (unit-weight) pending samples in one
        host pass, the cumulative-weight rank query that ``kll_quantiles`` runs."""
        if self._count == 0:
            return [None] * len(qs)
        with self._fold_lock, self._lock:
            sketch = self._sketch
            pending = list(self._pending)
        if sketch is not None:
            values, weights = _host_points(sketch)
        else:
            values = np.zeros((0,), np.float64)
            weights = np.zeros((0,), np.float64)
        if pending:
            values = np.concatenate([values, np.asarray(pending, np.float64)])
            weights = np.concatenate([weights, np.ones(len(pending), np.float64)])
        return _rank_query(values, weights, qs)

    def window(self, window_s: float, now: Optional[float] = None) -> List[float]:
        """Values of retained points newer than ``now - window_s`` (oldest first)."""
        t1 = time.monotonic() if now is None else now
        t0 = t1 - float(window_s)
        with self._lock:
            pts = list(self._points)
        return [v for (t, v) in pts if t > t0]

    def rate_over(self, window_s: float, now: Optional[float] = None) -> float:
        """Observations per second over the window (the event-rate view: one point per event)."""
        if window_s <= 0:
            return 0.0
        return len(self.window(window_s, now=now)) / float(window_s)

    def mean_over(self, window_s: float, now: Optional[float] = None) -> Optional[float]:
        vals = self.window(window_s, now=now)
        return (sum(vals) / len(vals)) if vals else None

    def bad_fraction_over(
        self,
        window_s: float,
        threshold: float,
        bad_when: str = "above",
        now: Optional[float] = None,
    ) -> Optional[float]:
        """Fraction of windowed samples violating ``threshold``: the SLO error rate.

        ``bad_when="above"`` counts ``value > threshold`` as bad, ``"below"`` counts
        ``value < threshold``. None when the window holds no samples (no evidence, not "ok").
        """
        vals = self.window(window_s, now=now)
        if not vals:
            return None
        if bad_when == "above":
            bad = sum(1 for v in vals if v > threshold)
        else:
            bad = sum(1 for v in vals if v < threshold)
        return bad / len(vals)

    def state_bytes(self) -> int:
        """Fixed memory footprint bound (ring, sketch, pending), independent of the stream's length."""
        from torchmetrics_tpu_torch.sketch.kll import kll_state_bytes

        ring = (self._points.maxlen or 0) * 2 * 8
        return ring + kll_state_bytes(self._capacity, self._levels) + self._fold_every * 8

    def summary(self) -> Dict[str, Any]:
        """Point-in-time summary (JSON-serialisable)."""
        out: Dict[str, Any] = {"count": self._count, "last": self._last, "sum": round(self._total, 6)}
        if self._count:
            p50, p90, p99 = self.quantiles((0.5, 0.9, 0.99))
            out.update({"p50": round(p50, 3), "p90": round(p90, 3), "p99": round(p99, 3)})
        return out

    def sketch_payload(self) -> Dict[str, Any]:
        """Wire-format view for a fleet-side merge: the sketch as base64 float32 bytes with its
        ``(levels, capacity)`` geometry, the pending samples raw. :func:`merged_quantiles`
        reassembles both sides, so a pooled quantile is a real ``kll_merge`` of per-peer sketches,
        never an average of per-peer quantiles."""
        import base64

        with self._fold_lock, self._lock:
            sketch = self._sketch
            pending = list(self._pending)
            count, total, last = self._count, self._total, self._last
        if sketch is not None:
            state = sketch.cpu().numpy().astype(np.float32)
            encoded = base64.b64encode(state.tobytes()).decode("ascii")
        else:
            encoded = None
        return {
            "name": self.name,
            "count": count,
            "sum": round(total, 6),
            "last": last,
            "capacity": self._capacity,
            "levels": self._levels,
            "sketch": encoded,
            "pending": [float(v) for v in pending],
        }

    def __repr__(self) -> str:
        return f"TimeSeries({self.name!r}, count={self._count}, last={self._last})"


# -------------------------------------------------------------------- fleet-side merge
def merged_quantiles(payloads: Sequence[Dict[str, Any]], qs: Sequence[float],
                     device: Any = None) -> List[Optional[float]]:
    """Mergeable-sketch quantiles over per-peer :meth:`TimeSeries.sketch_payload` s.

    Payloads of one sketch geometry merge with ``kll_merge`` on ``device`` (the card unless the
    caller names another); the merged supports plus every peer's raw pending samples then answer
    one cumulative-weight rank query on the host. Mixed geometries pool weighted points, never
    averaged quantiles. ``None`` s when no peer has seen a sample.
    """
    import base64

    import torch

    groups: Dict[tuple, Any] = {}  # (levels, capacity) -> merged sketch
    values = np.zeros((0,), np.float64)
    weights = np.zeros((0,), np.float64)
    pending_all: List[float] = []
    dev = None
    for p in payloads:
        pending_all.extend(float(v) for v in p.get("pending") or ())
        encoded = p.get("sketch")
        if not encoded:
            continue
        from torchmetrics_tpu_torch.metric import resolve_device
        from torchmetrics_tpu_torch.sketch.kll import kll_merge

        dev = dev or resolve_device(device)
        levels, capacity = int(p["levels"]), int(p["capacity"])
        state = np.frombuffer(base64.b64decode(encoded), np.float32).reshape(levels, capacity + 2)
        sk = torch.from_numpy(state.copy()).to(dev)
        key = (levels, capacity)
        prev = groups.get(key)
        groups[key] = sk if prev is None else kll_merge(prev, sk)
    for sk in groups.values():
        v, w = _host_points(sk)
        values = np.concatenate([values, v])
        weights = np.concatenate([weights, w])
    if pending_all:
        values = np.concatenate([values, np.asarray(pending_all, np.float64)])
        weights = np.concatenate([weights, np.ones(len(pending_all), np.float64)])
    finite = np.isfinite(values)
    return _rank_query(values[finite], weights[finite], qs)
