"""State sync across processes: the replicated core of ``torchmetrics_tpu/parallel/sync.py``.

Each process holds a full replica of a metric's state (data parallelism, as under DDP). At
``compute`` the replicas are gathered and reduced by each state's ``dist_reduce_fx``:

==================  ============================================================================
reduction            what every rank holds after the sync
==================  ============================================================================
``sum``              the per-rank states added in rank order
``mean``             that sum over the world size
``max`` / ``min``    the elementwise extreme over the ranks
``cat``              the per-rank states concatenated along dim 0, in rank order
``None``             the per-rank states stacked along a new leading world axis
callable             the callable applied to that stack
list state           the per-rank entries, each rank's concatenated before the gather
==================  ============================================================================

Two paths, as in the JAX package:

- :func:`process_sync` (``sync.py:931``), the eager path of ``Metric.compute``: one
  :func:`gather_all_arrays` per state (shapes exchanged, dim 0 padded to the largest, one
  all-gather, each rank's piece trimmed to its own length), then the reduction on the host's
  schedule (:func:`_reduce_gathered`, in rank order, so every rank holds the same bits);
- :func:`sync_state` (``sync.py:653``), the in-program counterpart: ``all_reduce`` and
  all-gathers with no host read, for states of the same shape on every rank.

Every rank joins every collective, in the same order: a rank whose list state is empty still
gathers it. The default :class:`SyncOptions` turn no collective's failure into a local value.

Bounded sync (``sync.py:123-610``, ``:742-795``, ``:1003-1315``): with ``SyncOptions(timeout_s > 0)`` each
gather runs on a worker thread against a whole-sync deadline, with retries and (decorrelated, seeded) backoff.
A state whose gather is exhausted aggregates over the ranks that answered when a quorum is set (a ``sum``
rescaled by ``world/k``), keeps its local value under degraded mode, or raises :class:`SyncTimeoutError`.
The result grades ``full | quorum | local``. A process-global :class:`HealthLedger` evicts a rank that
misses ``evict_after`` syncs in a row from gathers that take a ``ranks`` keyword, probes it with exponential
backoff and re-admits it when it answers. Wire compression (ROADMAP queue A item 9b) and the sharded
reduce-scatter (item 9c) are not ported yet: a ``compression`` other than ``"none"`` raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import Tensor

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.utils.exceptions import SyncTimeoutError
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

ReduceFx = Union[str, Callable, None]

#: where what is not ported of the JAX module waits: wire compression, then the shard and the mesh
NOT_PORTED = "ROADMAP queue A items 9b and 9c"
#: the wire codecs the JAX package knows (``compress.py:55``); only ``"none"`` is ported
COMPRESSION_MODES = ("none", "bf16", "int8")
#: the dtypes a gather can carry, by the code the shape exchange sends
_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int64, torch.int32, torch.int16,
           torch.int8, torch.uint8, torch.bool)
#: the most dimensions a gathered state may have
_MAX_NDIM = 8

# ------------------------------------------------------------------ bounded-sync options
ENV_SYNC_TIMEOUT = "TM_TPU_SYNC_TIMEOUT_S"
ENV_SYNC_RETRIES = "TM_TPU_SYNC_RETRIES"
ENV_SYNC_BACKOFF = "TM_TPU_SYNC_BACKOFF_S"
ENV_SYNC_DEGRADED = "TM_TPU_SYNC_DEGRADED"
ENV_SYNC_QUORUM = "TM_TPU_SYNC_QUORUM"
ENV_SYNC_EVICT_AFTER = "TM_TPU_SYNC_EVICT_AFTER"
ENV_SYNC_PROBE_BACKOFF = "TM_TPU_SYNC_PROBE_BACKOFF_S"
ENV_SYNC_JITTER = "TM_TPU_SYNC_JITTER"
ENV_SYNC_COMPRESSION = "TM_TPU_SYNC_COMPRESSION"

#: the jitter RNG of the bounded sync's retries and of the serving tier's blocked-producer park (JAX
#: ``sync.py:76-90``): seeded from the chaos harness's fixed seed when one is pinned (``TM_TPU_CHAOS_SEED``) so
#: jittered schedules replay under fault injection; free-running entropy otherwise
_BACKOFF_RNG: Optional[Any] = None


def _backoff_rng() -> Any:
    global _BACKOFF_RNG
    if _BACKOFF_RNG is None:
        import random

        seed = os.environ.get("TM_TPU_CHAOS_SEED", "")
        _BACKOFF_RNG = random.Random(int(seed)) if seed.lstrip("-").isdigit() else random.Random()
    return _BACKOFF_RNG


def reset_backoff_rng() -> None:
    """Re-derive the jitter RNG from the current env (tests re-pinning the chaos seed)."""
    global _BACKOFF_RNG
    _BACKOFF_RNG = None


class ConsistencyLevel(str):
    """Grade of a sync: ``full | quorum | local`` (``sync.py:92``). ``bool(level)`` is True only
    for ``full``: any degraded sync (quorum or local) is not world-consistent."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return str.__eq__(self, "full")


FULL = ConsistencyLevel("full")
QUORUM = ConsistencyLevel("quorum")
LOCAL = ConsistencyLevel("local")


def as_consistency(value: Any) -> ConsistencyLevel:
    """A bool or raw string consistency flag as its grade (``sync.py:112``)."""
    if isinstance(value, ConsistencyLevel):
        return value
    if isinstance(value, str):
        if value == "quorum":
            return QUORUM
        return FULL if value == "full" else LOCAL
    return FULL if value else LOCAL


def _validate_compression(mode: Any) -> str:
    """Normalise a compression mode as the JAX package does (``compress.py:81``); a known mode other than
    ``"none"`` raises ``NotImplementedError`` until the codecs are ported."""
    m = str(mode or "none").strip().lower()
    if m not in COMPRESSION_MODES:
        raise ValueError(f"unknown sync compression mode {mode!r}; expected one of {COMPRESSION_MODES}")
    if m != "none":
        raise NotImplementedError(
            f"SyncOptions(compression={m!r}): compressed sync is not ported yet (ROADMAP queue A item 9b);"
            " only compression='none' is supported"
        )
    return m


@dataclasses.dataclass(frozen=True)
class SyncOptions:
    """Bounding and elasticity policy of :func:`process_sync` (``sync.py:124``), with its fields and defaults.

    ``timeout_s == 0`` (the default) turns bounding off: gathers run inline on the calling thread, the
    unbounded path. With a positive timeout each gather runs on a worker thread against a *whole-sync*
    deadline; a timed-out or failed gather is retried up to ``retries`` times with backoff (decorrelated
    jitter drawn from ``[backoff_s, 3 * previous]`` when ``backoff_jitter``, else ``backoff_s * 2**attempt``).
    On exhaustion, in order of preference:

    1. **quorum** (``quorum`` set, and the partial responses the gather attached to its
       :class:`SyncTimeoutError` cover at least the quorum): aggregate over the responding ranks, a ``sum``
       rescaled by ``world/k`` (``quorum_rescale=False`` keeps the exact partial sum), ``mean`` over the
       responders, ``min``/``max``/``cat`` exact over the responding subset. The result grades ``quorum``.
    2. **local fallback** (``degraded_mode=True``): the state keeps its local value, graded ``local``.
    3. **strict** (``degraded_mode=False``): :class:`SyncTimeoutError` propagates.

    ``quorum`` is an absolute rank count (int >= 1) or a world fraction (float in (0, 1]). ``world`` overrides
    the process group's size, for emulated worlds driven through an injected gather (tests, the chaos
    harness). ``evict_after``/``probe_backoff_s`` configure the per-rank circuit breaker (:class:`HealthLedger`).
    ``compression`` must be ``"none"``: the codecs are ROADMAP queue A item 9b.
    """

    timeout_s: float = 0.0
    retries: int = 2
    backoff_s: float = 0.05
    backoff_jitter: bool = True
    degraded_mode: bool = True
    quorum: Optional[Union[int, float]] = None
    quorum_rescale: bool = True
    world: Optional[int] = None
    evict_after: int = 3
    probe_backoff_s: float = 1.0
    compression: str = "none"

    def __post_init__(self) -> None:
        # normalise and validate eagerly, so a typo'd mode fails where the options are built
        object.__setattr__(self, "compression", _validate_compression(self.compression))

    @property
    def bounded(self) -> bool:
        return self.timeout_s > 0


def _parse_quorum(raw: Optional[str]) -> Optional[Union[int, float]]:
    """``"0.5"`` is a fraction of the world, ``"2"`` an absolute rank count; unset or invalid is None."""
    if not raw:
        return None
    try:
        val = float(raw) if "." in raw else int(raw)
    except (TypeError, ValueError):
        return None
    return val if val > 0 else None


def _parse_compression(raw: Optional[str]) -> str:
    """Env-lenient mode parse (``sync.py:196``): unset or invalid values fall back to ``"none"``. A known mode
    other than ``"none"`` is kept, and :class:`SyncOptions` refuses it."""
    m = str(raw or "none").strip().lower()
    return m if m in COMPRESSION_MODES else "none"


def sync_options_from_env() -> SyncOptions:
    """:class:`SyncOptions` from the ``TM_TPU_SYNC_*`` environment knobs (``sync.py:204``)."""

    def _f(name: str, default: float) -> float:
        try:
            return float(os.environ.get(name, default))
        except (TypeError, ValueError):
            return default

    return SyncOptions(
        timeout_s=_f(ENV_SYNC_TIMEOUT, 0.0),
        retries=int(_f(ENV_SYNC_RETRIES, 2)),
        backoff_s=_f(ENV_SYNC_BACKOFF, 0.05),
        backoff_jitter=str(os.environ.get(ENV_SYNC_JITTER, "1")).strip().lower() not in ("0", "false", "no", "off"),
        degraded_mode=str(os.environ.get(ENV_SYNC_DEGRADED, "1")).strip().lower() not in ("0", "false", "no", "off"),
        quorum=_parse_quorum(os.environ.get(ENV_SYNC_QUORUM)),
        evict_after=int(_f(ENV_SYNC_EVICT_AFTER, 3)),
        probe_backoff_s=_f(ENV_SYNC_PROBE_BACKOFF, 1.0),
        compression=_parse_compression(os.environ.get(ENV_SYNC_COMPRESSION)),
    )


class SyncedState(dict):
    """:func:`process_sync`'s result (``sync.py:228``): the synced state dict plus world-consistency metadata.

    ``world_consistent`` is the grade: ``full`` when every state gathered from the whole world, ``quorum`` when
    at least one state aggregated over a responding subset (a quorum fallback or a circuit-broken gather group),
    ``local`` when any state fell back to its local value. ``degraded_states`` names the local-fallback states,
    ``quorum_states`` the subset-aggregated ones, ``responding_ranks`` maps each state to the ranks its value
    covers, and ``readmitted_ranks`` lists the evicted ranks that answered their probe in this sync.
    ``gather_latency_us`` maps each state to the wall time of its gather on this rank; ``bytes_shipped`` counts
    this rank's payloads, ``bytes_received`` the gathered pieces it holds. ``sharded_states``,
    ``compressed_states`` and ``bytes_saved`` keep their empty values and ``compression`` is ``"none"`` until
    the shard and the codecs are ported (ROADMAP queue A items 9b and 9c).
    """

    world_consistent: ConsistencyLevel = FULL
    degraded_states: Tuple[str, ...] = ()
    quorum_states: Tuple[str, ...] = ()
    responding_ranks: Dict[str, Tuple[int, ...]] = {}
    readmitted_ranks: Tuple[int, ...] = ()
    gather_latency_us: Dict[str, float] = {}
    bytes_shipped: int = 0
    bytes_received: int = 0
    bytes_saved: int = 0
    sharded_states: Tuple[str, ...] = ()
    compression: str = "none"
    compressed_states: Tuple[str, ...] = ()


# ------------------------------------------------------------------ rank health ledger
@dataclasses.dataclass
class RankHealth:
    """Per-rank health record (``sync.py:267``): the consecutive-miss breaker and a latency EWMA."""

    rank: int
    consecutive_failures: int = 0
    total_failures: int = 0
    successes: int = 0
    latency_ewma_us: Optional[float] = None
    evicted: bool = False
    evicted_at: float = 0.0  # monotonic time of the eviction or of the last failed probe
    failed_probes: int = 0  # probes since the eviction (the backoff's exponent)
    readmissions: int = 0

    def as_dict(self) -> Dict[str, Any]:
        return {
            "rank": self.rank,
            "consecutive_failures": self.consecutive_failures,
            "total_failures": self.total_failures,
            "successes": self.successes,
            "latency_ewma_us": None if self.latency_ewma_us is None else round(self.latency_ewma_us, 1),
            "evicted": self.evicted,
            "failed_probes": self.failed_probes,
            "readmissions": self.readmissions,
        }


class HealthLedger:
    """Process-global per-rank health: circuit breakers over the eager gather group (``sync.py:293``).

    A rank that misses ``evict_after`` consecutive syncs is **evicted**: later gathers that take a ``ranks``
    keyword exclude it (so one flapping peer stops stalling every sync at the full deadline) and grade
    ``quorum``. An evicted rank is **probed** by putting it back in the gather group once its backoff
    (``probe_backoff_s * 2**failed_probes``, capped) has passed; a successful probe **re-admits** it
    (``sync.rank_readmissions``), a failed one deepens the backoff. Rank attribution needs a gather that can
    name responders (partial ``responses`` on its :class:`SyncTimeoutError`, or a ``ranks``-aware subgroup
    gather); the stock :func:`gather_all_arrays` is all-or-nothing, so with it the ledger never counts a miss.
    The ledger is used from the syncing thread only and takes no lock.
    """

    EWMA_ALPHA = 0.2

    def __init__(self, evict_after: int = 3, probe_backoff_s: float = 1.0, probe_backoff_cap_s: float = 60.0) -> None:
        self.evict_after = evict_after
        self.probe_backoff_s = probe_backoff_s
        self.probe_backoff_cap_s = probe_backoff_cap_s
        self.ranks: Dict[int, RankHealth] = {}

    def configure(self, opts: SyncOptions) -> None:
        """Adopt the breaker thresholds of the options driving the current sync."""
        self.evict_after = max(1, int(opts.evict_after)) if opts.evict_after else 0
        self.probe_backoff_s = max(0.0, float(opts.probe_backoff_s))

    def _get(self, rank: int) -> RankHealth:
        h = self.ranks.get(rank)
        if h is None:
            h = self.ranks[rank] = RankHealth(rank=int(rank))
        return h

    def record_success(self, rank: int, latency_us: Optional[float] = None) -> bool:
        """Mark a responding rank healthy; True when this re-admitted an evicted rank."""
        h = self._get(rank)
        h.successes += 1
        h.consecutive_failures = 0
        if latency_us is not None:
            if h.latency_ewma_us is None:
                h.latency_ewma_us = float(latency_us)
            else:
                h.latency_ewma_us += self.EWMA_ALPHA * (float(latency_us) - h.latency_ewma_us)
        if h.evicted:
            h.evicted = False
            h.failed_probes = 0
            h.readmissions += 1
            obs.telemetry.counter("sync.rank_readmissions").inc()
            obs.telemetry.event("sync.rank_readmitted", cat="sync", args={"rank": h.rank})
            obs.flightrec.record("rank.readmitted", rank=h.rank, readmissions=h.readmissions)
            rank_zero_warn(
                f"process_sync: rank {h.rank} answered its health probe and was re-admitted"
                " to the gather group. Reconcile its state before trusting full-world"
                " results (docs/robustness.md, 'Re-admission handshake').",
                UserWarning,
            )
            return True
        return False

    def record_failure(self, rank: int) -> bool:
        """Mark a missing rank; True when this call tripped its circuit breaker."""
        h = self._get(rank)
        h.total_failures += 1
        h.consecutive_failures += 1
        now = time.monotonic()
        if h.evicted:
            # a failed probe: deepen the backoff and restart its clock
            h.failed_probes += 1
            h.evicted_at = now
            return False
        if self.evict_after and h.consecutive_failures >= self.evict_after:
            h.evicted = True
            h.evicted_at = now
            h.failed_probes = 0
            obs.telemetry.counter("sync.rank_evictions").inc()
            obs.telemetry.event("sync.rank_evicted", cat="sync",
                                args={"rank": h.rank, "consecutive_failures": h.consecutive_failures})
            obs.flightrec.record("rank.evicted", rank=h.rank, consecutive_failures=h.consecutive_failures)
            rank_zero_warn(
                f"process_sync: rank {h.rank} missed {h.consecutive_failures} consecutive"
                " sync(s) and was evicted from the gather group (circuit breaker). It will"
                f" be probed with exponential backoff (base {self.probe_backoff_s:g}s) and"
                " re-admitted when it answers.",
                UserWarning,
            )
            return True
        return False

    def _probe_due(self, h: RankHealth, now: float) -> bool:
        wait = min(self.probe_backoff_s * (2 ** h.failed_probes), self.probe_backoff_cap_s)
        return now - h.evicted_at >= wait

    def gather_group(self, world: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(the ranks to gather from, the subset of those that are probes whose backoff has passed)."""
        now = time.monotonic()
        group: List[int] = []
        probes: List[int] = []
        for r in range(world):
            h = self.ranks.get(r)
            if h is None or not h.evicted:
                group.append(r)
            elif self._probe_due(h, now):
                group.append(r)
                probes.append(r)
        return tuple(group), tuple(probes)

    def evicted_ranks(self) -> Tuple[int, ...]:
        return tuple(sorted(r for r, h in self.ranks.items() if h.evicted))

    def observe_latencies(self, per_rank_mean_us: Sequence[float]) -> None:
        """Fold a cross-rank latency gather (:func:`skew_report`) into the per-rank EWMAs."""
        for rank, us in enumerate(per_rank_mean_us):
            h = self._get(rank)
            if h.latency_ewma_us is None:
                h.latency_ewma_us = float(us)
            else:
                h.latency_ewma_us += self.EWMA_ALPHA * (float(us) - h.latency_ewma_us)

    def report(self) -> Dict[int, Dict[str, Any]]:
        return {r: h.as_dict() for r, h in sorted(self.ranks.items())}

    def reset(self) -> None:
        self.ranks.clear()


_HEALTH: Optional[HealthLedger] = None


def health_ledger() -> HealthLedger:
    """The process-global rank health ledger (made at first use)."""
    global _HEALTH
    if _HEALTH is None:
        _HEALTH = HealthLedger()
    return _HEALTH


def reset_health_state() -> None:
    """Drop every per-rank health record (tests, the chaos harness)."""
    if _HEALTH is not None:
        _HEALTH.reset()


# ------------------------------------------------------------------ cross-rank skew report
#: recent per-gather latencies on this rank (bounded; they feed skew_report)
_GATHER_LATENCIES_US: "deque" = deque(maxlen=1024)
_LAST_SKEW: Optional[Dict[str, Any]] = None


def _record_gather_latency(dur_s: float, device: Any = None) -> None:
    us = dur_s * 1e6
    _GATHER_LATENCIES_US.append(us)
    obs.telemetry.histogram("sync.gather.latency_us").record(us)
    # the always-on live series of gather latency (windowed rate, all-time KLL quantiles), addressable by SLO
    # specs; it keeps its sketch on the device of the first sync that records it
    obs.telemetry.series("sync.gather_latency_us", device=device).record(us)


def local_gather_stats() -> Optional[Dict[str, Any]]:
    """Mean, p50 and max of this rank's recent gather latencies; None before any sync ran."""
    if not _GATHER_LATENCIES_US:
        return None
    vals = sorted(_GATHER_LATENCIES_US)
    n = len(vals)
    return {
        "count": n,
        "mean_us": round(sum(vals) / n, 1),
        "p50_us": round(vals[n // 2], 1),
        "max_us": round(vals[-1], 1),
    }


def skew_report(gather_fn: Optional[Callable] = None) -> Optional[Dict[str, Any]]:
    """Cross-rank gather-latency skew (``sync.py:479``): each rank's mean recent gather latency, gathered
    (one small collective under a process group, or ``gather_fn`` injected), and ``straggler_index = max /
    median`` with the offending rank named. The per-rank means feed the :class:`HealthLedger`'s EWMAs, and the
    ledger's breaker states ride along under ``health``. The result is kept (:func:`last_skew_report`). None
    when no gather latency has been recorded yet.
    """
    global _LAST_SKEW
    local = local_gather_stats()
    if local is None:
        return None
    world, rank = _world_size(), _local_rank()
    payload = torch.tensor([local["mean_us"]], dtype=torch.float32)
    if gather_fn is not None:
        gathered = [torch.as_tensor(g).reshape(-1) for g in gather_fn(payload, None)]
    elif world > 1:
        gathered = [g.reshape(-1) for g in gather_all_arrays(payload)]
    else:
        gathered = [payload]
    per_rank = [round(float(g[0]), 1) for g in gathered]
    ranked = sorted(per_rank)
    median = ranked[len(ranked) // 2] or 1.0
    worst = max(per_rank)
    ledger = health_ledger()
    ledger.observe_latencies(per_rank)
    report = {
        "world": len(per_rank),
        "rank": rank,
        "per_rank_mean_us": per_rank,
        "straggler_rank": int(per_rank.index(worst)),
        "straggler_index": round(worst / median, 3) if median else 1.0,
        "local": local,
    }
    if ledger.ranks:
        report["health"] = ledger.report()
        report["evicted_ranks"] = ledger.evicted_ranks()
    _LAST_SKEW = report
    obs.telemetry.event("sync.skew_report", cat="sync", args=report)
    return report


def last_skew_report() -> Optional[Dict[str, Any]]:
    """The most recent :func:`skew_report` result (no collective); None if never run."""
    return _LAST_SKEW


def reset_skew_state() -> None:
    """Drop the recorded gather latencies and the kept skew report (tests)."""
    global _LAST_SKEW
    _GATHER_LATENCIES_US.clear()
    _LAST_SKEW = None


def _bounded_gather(
    gather: Callable, value: Any, group: Optional[Any], kw: Dict[str, Any],
    opts: SyncOptions, deadline: float, state_name: str,
) -> List[Any]:
    """One gather against the sync's deadline, retried with backoff (``sync.py:542``).

    The gather runs on a daemon worker thread, so a peer that never answers cannot wedge the process: the
    thread is abandoned at the deadline (a blocked collective cannot be cancelled; abandon, then retry or
    degrade). Raises :class:`SyncTimeoutError` when the deadline or the retries are spent, carrying the partial
    per-rank ``responses`` the last failed gather attached, so that the caller can try a quorum.

    A new thread starts on card 0 and its default stream, so the worker takes the caller's current card and
    stream: an NCCL world of one process per card gathers on each process's own card, and the gather is ordered
    after the caller's work on its stream.
    """
    on_caller_stream = _caller_stream_context()
    attempt = 0
    last_error: Optional[BaseException] = None
    prev_pause = opts.backoff_s
    while True:
        # the clock decides when to stop waiting on a straggler, never which batch lands where
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise SyncTimeoutError(
                f"sync of state {state_name!r} exhausted its {opts.timeout_s:g}s deadline"
                f" after {attempt} attempt(s)",
                responses=getattr(last_error, "responses", None),
            )
        result: List[Any] = []
        error: List[BaseException] = []
        done = threading.Event()

        def _work() -> None:
            try:
                with on_caller_stream():
                    result.append(gather(value, group, **kw))
            except BaseException as err:  # noqa: BLE001 - crosses the thread boundary, re-raised by the caller
                error.append(err)
            finally:
                done.set()

        worker = threading.Thread(target=_work, daemon=True, name="tm-tpu-sync-gather")
        worker.start()
        finished = done.wait(remaining)
        if finished and result:
            return result[0]
        if finished and error:
            last_error = error[0]
        attempt += 1
        obs.telemetry.counter("robust.sync_retries").inc()
        if attempt > opts.retries:
            detail = f"last error: {last_error!r}" if last_error is not None else "gather hung past the deadline"
            raise SyncTimeoutError(
                f"sync of state {state_name!r} failed after {attempt} attempt(s)"
                f" within its {opts.timeout_s:g}s deadline ({detail})",
                responses=getattr(last_error, "responses", None),
            )
        # decorrelated jitter (pause drawn from [base, 3 * previous]) spreads the retries of ranks that shared a
        # stall; without it the backoff is exponential. The pause never outlives the deadline.
        if opts.backoff_jitter:
            pause = _backoff_rng().uniform(opts.backoff_s, max(opts.backoff_s, prev_pause * 3.0))
        else:
            pause = opts.backoff_s * (2 ** (attempt - 1))
        prev_pause = pause
        pause = min(pause, max(0.0, deadline - time.monotonic()))
        if pause > 0:
            time.sleep(pause)


def _caller_stream_context() -> Callable[[], Any]:
    """A factory of contexts that put another thread on this thread's current card and stream; a no-op where
    CUDA is not initialised (the CPU, or no card touched yet)."""
    if not torch.cuda.is_initialized():
        return contextlib.nullcontext
    stream = torch.cuda.current_stream()

    @contextlib.contextmanager
    def _on_caller_stream() -> Iterator[None]:
        with torch.cuda.device(stream.device), torch.cuda.stream(stream):
            yield

    return _on_caller_stream


# ------------------------------------------------------------------ the process group
def _initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def distributed_available() -> bool:
    """True when ``torch.distributed`` is initialised with a world above 1 (JAX ``metric.py:69``)."""
    return _initialised() and dist.get_world_size() > 1


def _world_size(group: Optional[Any] = None) -> int:
    return dist.get_world_size(group) if _initialised() else 1


def _sync_world(opts: SyncOptions, group: Optional[Any] = None) -> int:
    """The world a sync grades against: ``opts.world`` when set (an emulated world), else the group's size."""
    return max(1, int(opts.world)) if opts.world is not None else _world_size(group)


def _local_rank(group: Optional[Any] = None) -> int:
    return dist.get_rank(group) if _initialised() else 0


def _wire_device(group: Optional[Any]) -> torch.device:
    """Where a collective's tensors live, by the group's backend: the current card for NCCL, the
    host for every other backend (gloo's CUDA support does not cover every collective)."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather_single(out: Tensor, value: Tensor, group: Optional[Any]) -> None:
    """The ranks' ``value`` concatenated along dim 0 into ``out``: ``all_gather_single``, named
    ``all_gather_into_tensor`` before PyTorch 2.12."""
    (getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor)(out, value, group=group)


def _to_wire(value: Tensor, device: torch.device) -> Tensor:
    """``value`` on ``device``, contiguous, bool carried as uint8 (NCCL has no bool type)."""
    value = value.to(device)
    return (value.to(torch.uint8) if value.dtype == torch.bool else value).contiguous()


# ------------------------------------------------------------------ the eager gather
def _gather_meta(shape: Tuple[int, ...], dtype: torch.dtype, group: Optional[Any]) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
    """Every rank's (shape, dtype), by one all-gather of a small int64 tensor, read on the host.
    Ranks may differ in ``ndim``."""
    if len(shape) > _MAX_NDIM:
        raise ValueError(f"Cannot gather a state of {len(shape)} dimensions; at most {_MAX_NDIM} are supported")
    if dtype not in _DTYPES:
        raise ValueError(f"Cannot gather a state of dtype {dtype}; the supported dtypes are {_DTYPES}")
    row = [_DTYPES.index(dtype), len(shape), *shape] + [0] * (_MAX_NDIM - len(shape))
    device = _wire_device(group)
    world = dist.get_world_size(group)
    out = torch.empty((world, len(row)), dtype=torch.int64, device=device)
    _all_gather_single(out, torch.tensor([row], dtype=torch.int64, device=device), group)
    return [(tuple(r[2:2 + r[1]]), _DTYPES[r[0]]) for r in out.tolist()]


def all_gather_object_shapes(local_shape: tuple, group: Optional[Any] = None) -> List[tuple]:
    """Every rank's shape of a state (``sync.py:697``, reference ``distributed.py:118-127``)."""
    if not _initialised():
        return [tuple(local_shape)]
    return [shape for shape, _ in _gather_meta(tuple(local_shape), torch.float32, group)]


def gather_all_arrays(value: Tensor, group: Optional[Any] = None) -> List[Tensor]:
    """``value`` from every rank of ``group``, in rank order (``sync.py:705``, reference
    ``gather_all_tensors``, ``distributed.py:97-147``).

    Without an initialised process group it returns ``[value]``. Under one, a world of 1
    included (there NCCL runs its all-gather on the card too), it exchanges every rank's shape and
    dtype, pads dim 0 to the largest, all-gathers once, and trims each rank's piece to its own
    length: ranks may hold different numbers of rows. A rank with no rows (an empty list state's
    placeholder, or an idle rank's empty ``cat`` state) takes the dtype and trailing shape of the
    first rank that has rows, so the pieces concatenate without a cast.

    The device is chosen by the backend, never by a caught error: on a NCCL group the payload
    stays on the card; on any other backend (gloo) it is copied to the host for the collective,
    and each piece is copied back to ``value``'s device, because gloo's CUDA support does not cover
    every collective. Each piece is returned on ``value``'s device.
    """
    if not _initialised():
        return [value]
    meta = _gather_meta(tuple(value.shape), value.dtype, group)
    scalar = all(len(shape) == 0 for shape, _ in meta)
    if scalar:
        meta = [((1,), dtype) for _, dtype in meta]
    elif any(len(shape) == 0 for shape, _ in meta):
        raise ValueError(f"Cannot gather a state that is a scalar on some ranks and not on others: {meta}")
    rows = [shape[0] for shape, _ in meta]
    donor = next((m for m, n in zip(meta, rows) if n > 0), meta[0])
    trailing, dtype = donor[0][1:], donor[1]
    for (shape, d), n in zip(meta, rows):
        if n > 0 and (shape[1:] != trailing or d != dtype):
            raise ValueError(f"Cannot gather a state whose ranks hold rows of different shapes or dtypes: {meta}")
    world, own = len(meta), rows[_local_rank(group)]
    if max(rows) == 0:  # every rank is empty: no rows to gather
        return [torch.empty((0, *trailing), dtype=dtype, device=value.device) for _ in range(world)]
    device = _wire_device(group)
    local = _to_wire(value.reshape(own, *trailing).to(dtype), device)
    if own < max(rows):
        local = torch.cat([local, local.new_zeros((max(rows) - own, *trailing))])
    out = local.new_empty((world * max(rows), *trailing))
    _all_gather_single(out, local, group)
    pieces = out.view(world, max(rows), *trailing)
    gathered = [pieces[r, :rows[r]].to(device=value.device, dtype=dtype) for r in range(world)]
    return [g.reshape(()) for g in gathered] if scalar else gathered


def quorum_threshold(quorum: Optional[Union[int, float]], world: int) -> int:
    """The least number of responding ranks for a quorum; 0 when quorum mode is off (``sync.py:742``).

    A float in (0, 1] is a fraction of the world (rounded up), an int an absolute count (clamped to the world).
    A world of one never takes a quorum.
    """
    if not quorum or world <= 1:
        return 0
    if isinstance(quorum, float) and quorum <= 1.0:
        return max(1, math.ceil(quorum * world))
    return max(1, min(int(quorum), world))


def _rescale_sum(value: Tensor, world: int, k: int) -> Tensor:
    """The full-world estimate of a sum of ``k`` of ``world`` contributions, ``value * world/k``
    (``sync.py:755``), in the state's dtype, with the JAX package's arithmetic: an integer sum is scaled in
    float32 and rounded half to even, a float sum scaled by ``world/k`` in its own dtype. ``k >= world`` is the
    identity."""
    if k >= world:
        return value
    if value.is_floating_point():
        return value * torch.tensor(world / k, dtype=value.dtype, device=value.device)
    scaled = value.to(torch.float32) * torch.tensor(world / k, dtype=torch.float32, device=value.device)
    return torch.round(scaled).to(value.dtype)


def _reduce_gathered(fx: ReduceFx, vals: List[Tensor], world: Optional[int] = None,
                     opts: Optional[SyncOptions] = None) -> Any:
    """The reduction of the per-rank states, in rank order (``sync.py:770``); every rank runs the
    same operations on the same pieces, so every rank holds the same bits.

    With ``k = len(vals)`` below ``world`` (a quorum, or a gather group without its evicted ranks), a ``sum`` is
    rescaled to a full-world estimate unless ``opts.quorum_rescale`` is False; ``mean`` is the responders' mean,
    and ``min``/``max``/``cat``/``None``/callables are exact over the responding subset."""
    if fx in ("sum", "mean"):
        total = vals[0]
        for v in vals[1:]:
            total = total + v
        if fx == "sum":
            rescale = world is not None and (opts is None or opts.quorum_rescale)
            return _rescale_sum(total, world, len(vals)) if rescale else total
        return (total if total.is_floating_point() else total.to(torch.float32)) / len(vals)
    if fx in ("max", "min"):
        out = vals[0]
        for v in vals[1:]:
            out = torch.maximum(out, v) if fx == "max" else torch.minimum(out, v)
        return out
    if fx == "cat":
        return torch.cat([torch.atleast_1d(v) for v in vals], dim=0)
    if fx is None:
        return torch.stack(vals)
    if callable(fx):
        return fx(torch.stack(vals))
    raise ValueError(f"Unsupported dist_reduce_fx: {fx!r}")


def _nbytes(value: Any) -> int:
    if isinstance(value, (list, tuple)):
        return sum(_nbytes(v) for v in value)
    return value.numel() * value.element_size() if isinstance(value, Tensor) else 0


def _gather_keywords(gather: Callable) -> Tuple[bool, bool]:
    """Whether ``gather`` takes a ``name`` keyword (or ``**kwargs``), and whether it takes ``ranks``."""
    try:
        params = inspect.signature(gather).parameters
    except (TypeError, ValueError):
        return False, False
    var_kw = any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values())
    return var_kw or "name" in params, "ranks" in params


def process_sync(
    state: Dict[str, Any],
    reductions: Dict[str, ReduceFx],
    gather_fn: Optional[Callable] = None,
    group: Optional[Any] = None,
    options: Optional[SyncOptions] = None,
    device: Union[str, torch.device, None] = None,
) -> SyncedState:
    """Gather every state of ``state`` across the world and reduce it by its ``reductions`` entry
    (``sync.py:931``: the replicated path ``:1129-1221``, the bounded, quorum, degraded and strict paths
    ``:1003-1060`` and ``:1149-1315``).

    ``gather_fn(value, group)`` returns the list of every rank's ``value`` (default
    :func:`gather_all_arrays`); one that takes a ``name`` keyword gets the state's name, so an
    injected gather (an emulated world) can key by state instead of matching values. One that takes a
    ``ranks`` keyword gets the circuit-broken gather group (evicted ranks left out, due probes put back) and
    answers with one entry per requested rank, in order. Every state is gathered, in the order of ``state``,
    on every rank:

    - a list state's entries are concatenated before the gather; an empty list gathers a float32
      ``(0,)`` placeholder on ``device`` (which :func:`gather_all_arrays` gives the other ranks'
      dtype and trailing shape), and the result keeps each rank's non-empty piece, in rank order:
      ``[]`` when every rank is empty;
    - one gathered entry (a world of 1) is returned as it is, with no world axis (``sync.py:1219``);
    - otherwise :func:`_reduce_gathered` reduces the entries.

    ``options`` default to :func:`sync_options_from_env`. With ``options.timeout_s > 0`` each gather races the
    sync's deadline (:func:`_bounded_gather`); a state whose gather is spent aggregates over the quorum of
    responding ranks when the options and the partial responses allow, keeps its local value under degraded
    mode, or raises :class:`SyncTimeoutError` (after opening a ``sync_timeout`` incident and capturing a
    bundle). The result grades ``full | quorum | local`` and names the degraded and quorum states.
    ``device`` places the empty placeholder (default: the device of the first tensor of ``state``, else the
    host).
    """
    obs.telemetry.counter("sync.process_sync.calls").inc()
    opts = options if options is not None else sync_options_from_env()
    t0 = time.perf_counter() if obs.telemetry.enabled else 0.0
    gather = gather_fn or gather_all_arrays
    takes_name, takes_ranks = _gather_keywords(gather)
    if device is None:
        first = next((v for v in state.values() if isinstance(v, Tensor)), None)
        device = first.device if first is not None else torch.device("cpu")
    world = _sync_world(opts, group)
    rank = _local_rank(group)
    ledger = health_ledger()
    ledger.configure(opts)
    # circuit breakers: evicted ranks leave the gather group until their probe is due
    gather_group: Tuple[int, ...] = tuple(range(world))
    if world > 1 and takes_ranks:
        gather_group, _ = ledger.gather_group(world)
    quorum_k = quorum_threshold(opts.quorum, world)
    deadline = time.monotonic() + opts.timeout_s if opts.bounded else 0.0
    degraded: List[str] = []
    quorum_states: List[str] = []
    responding: Dict[str, Tuple[int, ...]] = {}
    ok_ranks: set = set()
    failed_ranks: set = set()
    latency: Dict[str, float] = {}
    shipped = received = 0

    def run_gather(payload: Tensor, name: str, kw: Dict[str, Any]) -> List[Any]:
        g0 = time.perf_counter()
        try:
            if not opts.bounded:
                return list(gather(payload, group, **kw))
            return list(_bounded_gather(gather, payload, group, kw, opts, deadline, name))
        finally:
            dur = time.perf_counter() - g0
            latency[name] = dur * 1e6
            _record_gather_latency(dur, device)

    def note_responders(name: str, ranks_responded: Any) -> None:
        resp = tuple(sorted(int(r) for r in ranks_responded))
        responding[name] = resp
        if world > 1:
            ok_ranks.update(resp)
            failed_ranks.update(r for r in gather_group if r not in resp)

    def keep_rows(pieces: List[Tensor]) -> List[Tensor]:
        return [g for g in pieces if g.ndim == 0 or g.shape[0] > 0]

    out = SyncedState()
    for name, value in state.items():
        fx = reductions.get(name, "sum")
        kw: Dict[str, Any] = {}
        if takes_name:
            kw["name"] = name
        if takes_ranks and world > 1:
            kw["ranks"] = gather_group
        is_list = isinstance(value, (list, tuple))
        if is_list:
            payload = (torch.cat([torch.atleast_1d(v) for v in value], dim=0) if value
                       else torch.empty((0,), dtype=torch.float32, device=device))
        else:
            payload = value
        try:
            gathered = run_gather(payload, name, kw)
        except SyncTimeoutError as err:
            partial = dict(getattr(err, "responses", None) or {})
            # this rank's own contribution always responds: k >= 1, so the quorum arithmetic never divides by 0
            partial.setdefault(rank, payload)
            if quorum_k and len(partial) >= quorum_k:
                vals = [partial[r] for r in sorted(partial)]
                out[name] = keep_rows(vals) if is_list else _reduce_gathered(fx, vals, world, opts)
                quorum_states.append(name)
                note_responders(name, partial.keys())
                continue
            if not opts.degraded_mode:
                # the error is about to leave the sync layer: land the post-mortem bundle while the process can
                obs.flightrec.open_incident("sync_timeout")
                obs.flightrec.record("sync.timeout", state=name, world=world,
                                     responded=sorted(int(r) for r in partial))
                obs.capture_bundle("sync_timeout")
                raise
            degraded.append(name)
            out[name] = list(value) if is_list else value
            note_responders(name, partial.keys())
            continue
        shipped += _nbytes(payload)
        received += _nbytes(gathered)
        # a successful gather: attribute its entries to ranks where the layout allows
        resp: Optional[Tuple[int, ...]] = None
        if takes_ranks and world > 1 and len(gathered) == len(gather_group):
            resp = gather_group
        elif len(gathered) == world:
            resp = tuple(range(world))
        if resp is not None:
            note_responders(name, resp)
            if len(resp) < world:
                quorum_states.append(name)  # a subgroup gather: the evicted ranks are not covered
        else:
            responding[name] = tuple(range(len(gathered)))
        if is_list:
            out[name] = keep_rows(gathered)
        elif len(gathered) == 1 and world == 1:
            out[name] = gathered[0]
        else:
            out[name] = _reduce_gathered(fx, gathered, world, opts)

    # one health mark per rank per sync: any missed state counts as a miss
    readmitted: List[int] = []
    if world > 1 and (ok_ranks or failed_ranks):
        latencies = list(latency.values())
        mean_lat = (sum(latencies) / len(latencies)) if latencies else None
        for r in sorted(ok_ranks - failed_ranks):
            if ledger.record_success(r, mean_lat):
                readmitted.append(r)
        for r in sorted(failed_ranks):
            ledger.record_failure(r)

    level = LOCAL if degraded else (QUORUM if quorum_states else FULL)
    # the flight ring: one outcome per multi-rank sync, and a downgrade record whenever the grade left "full"
    if world > 1:
        obs.flightrec.record("sync.outcome", level=str(level), world=world, states=len(state))
    if level != FULL:
        obs.flightrec.record("sync.downgrade", level=str(level), degraded=tuple(degraded),
                             quorum=tuple(dict.fromkeys(quorum_states)))
    out.world_consistent = level
    out.degraded_states = tuple(degraded)
    out.quorum_states = tuple(dict.fromkeys(quorum_states))
    out.responding_ranks = responding
    out.readmitted_ranks = tuple(readmitted)
    out.gather_latency_us = latency
    out.bytes_shipped = shipped
    out.bytes_received = received
    if shipped or received:
        obs.telemetry.counter("sync.bytes_shipped").inc(shipped)
        obs.telemetry.counter("sync.bytes_received").inc(received)
    if quorum_states and not degraded:
        obs.telemetry.counter("sync.quorum_syncs").inc()
        obs.telemetry.event(
            "sync.quorum", cat="sync",
            args={"states": out.quorum_states, "responding_ranks": {k: list(v) for k, v in responding.items()},
                  "world": world, "quorum_k": quorum_k},
        )
        covered = sorted({r for v in responding.values() for r in v})
        rank_zero_warn(
            f"process_sync degraded to QUORUM: state(s) {sorted(out.quorum_states)} aggregated"
            f" over responding rank(s) {covered} of a {world}-rank world. Sum-reduced values"
            f" are {'rescaled full-world estimates' if opts.quorum_rescale else 'exact partial sums'};"
            " min/max/cat cover the responding subset only (docs/robustness.md).",
            UserWarning,
        )
    if degraded:
        obs.telemetry.counter("robust.degraded_syncs").inc()
        obs.telemetry.event("sync.degraded", cat="sync",
                            args={"states": degraded, "timeout_s": opts.timeout_s, "retries": opts.retries})
        rank_zero_warn(
            f"process_sync degraded: state(s) {sorted(degraded)} could not be gathered within"
            f" the {opts.timeout_s:g}s deadline ({opts.retries} retr{'y' if opts.retries == 1 else 'ies'});"
            " falling back to LOCAL state. The next compute() reflects this process only"
            " (non-world-consistent).",
            UserWarning,
        )
    if obs.telemetry.enabled:
        dur_us = (time.perf_counter() - t0) * 1e6
        obs.telemetry.histogram("sync.process_sync.latency_us").record(dur_us)
        obs.telemetry.event(
            "sync.process_sync", ph="X", cat="sync", ts_us=obs.telemetry.now_us() - dur_us, dur_us=dur_us,
            args={"world": world, "states": sorted(state), "bytes": obs.tree_bytes(state),
                  "consistency": str(level)},
        )
    return out


# ------------------------------------------------------------------ the in-program collective
def _reduce_one(value: Tensor, fx: ReduceFx, group: Optional[Any], world: int) -> Tensor:
    """One state through its collective (``sync.py:632``), on the wire device."""
    if fx in ("sum", "mean", "max", "min"):
        op = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[fx]
        dist.all_reduce(value, op=op, group=group)
        return value / world if fx == "mean" else value  # gloo has no AVG
    flat = torch.atleast_1d(value)
    out = flat.new_empty((world * flat.shape[0], *flat.shape[1:]))
    _all_gather_single(out, flat, group)
    if fx == "cat":
        return out
    stacked = out.view(world, *value.shape)
    if fx is None:
        return stacked
    if callable(fx):
        return fx(stacked)
    raise ValueError(f"Unsupported dist_reduce_fx: {fx!r}")


def sync_state(state: Dict[str, Any], reductions: Dict[str, ReduceFx], group: Optional[Any] = None) -> Dict[str, Any]:
    """Synchronise a state dict across ``group`` with collectives and no host read (``sync.py:653``):
    ``all_reduce`` for ``sum``, ``max`` and ``min``; ``mean`` as the sum over the world size;
    ``all_gather`` into one tensor for ``cat``; a stacked all-gather for ``None`` and callables.

    As JAX's in-program collective does, it needs every rank to hold each state in the same shape
    and dtype; list states are concatenated first and gathered as ``cat``, and an empty list stays
    empty (it must be empty on every rank). Integer states come back exact; float sums are added in
    the backend's order. On a non-NCCL group the tensors go through the host, as in
    :func:`gather_all_arrays`. Without an initialised process group the state is returned as it is.
    """
    if not _initialised():
        return dict(state)
    world = _world_size(group)
    device = _wire_device(group)
    out: Dict[str, Any] = {}
    for name, value in state.items():
        fx = reductions.get(name, "sum")
        if isinstance(value, (list, tuple)):
            if not value:
                out[name] = list(value)
                continue
            value, fx = torch.cat([torch.atleast_1d(v) for v in value], dim=0), ("cat" if fx in (None, "cat") else fx)
            wrap = True
        else:
            wrap = False
        wire = _to_wire(value, device)
        if wire is value:
            wire = wire.clone()  # the collective writes in place; the caller's state stays
        synced = _reduce_one(wire, fx, group, world)
        if value.dtype == torch.bool and synced.dtype == torch.uint8:
            synced = synced.to(torch.bool)
        synced = synced.to(value.device)
        out[name] = [synced] if wrap else synced
    return out


__all__ = [
    "ENV_SYNC_BACKOFF",
    "ENV_SYNC_COMPRESSION",
    "ENV_SYNC_DEGRADED",
    "ENV_SYNC_EVICT_AFTER",
    "ENV_SYNC_JITTER",
    "ENV_SYNC_PROBE_BACKOFF",
    "ENV_SYNC_QUORUM",
    "ENV_SYNC_RETRIES",
    "ENV_SYNC_TIMEOUT",
    "FULL",
    "LOCAL",
    "NOT_PORTED",
    "QUORUM",
    "ConsistencyLevel",
    "HealthLedger",
    "RankHealth",
    "ReduceFx",
    "SyncOptions",
    "SyncedState",
    "all_gather_object_shapes",
    "as_consistency",
    "distributed_available",
    "gather_all_arrays",
    "health_ledger",
    "last_skew_report",
    "local_gather_stats",
    "process_sync",
    "quorum_threshold",
    "reset_health_state",
    "reset_skew_state",
    "skew_report",
    "sync_options_from_env",
    "sync_state",
]
