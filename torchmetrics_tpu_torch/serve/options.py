"""Serving-tier policy: the bounded in-flight window and its on-full semantics (counterpart of
``torchmetrics_tpu/serve/options.py``).

The bound is the robustness property: an unbounded enqueue path turns a traffic spike
into host or device memory exhaustion, a bounded one turns it into *backpressure* — the caller
blocks, errors, or sheds, and the engine's memory footprint stays ``O(max_inflight +
staging_slots)`` batches whatever the arrival rate does. ``on_full`` picks the contract:

==========  =========================================================================
``block``   park the caller with exponential-backoff waits until a slot frees; give up
            with :class:`~torchmetrics_tpu_torch.utils.exceptions.BackpressureError` after
            ``queue_timeout_s`` (a stuck drain must not wedge the service forever)
``raise``   fail the enqueue immediately with :class:`BackpressureError` (the caller
            owns the retry/shed policy)
``shed``    drop the batch, count it (``serve.shed`` / ``robust.shed_batches``), warn
            once rank-zero, and return a ticket marked ``shed`` — graceful degradation
==========  =========================================================================

Env knobs (read by :func:`serve_options_from_env`, the default when ``update_async`` is
called on an unconfigured metric): ``TM_TPU_SERVE_MAX_INFLIGHT``, ``TM_TPU_SERVE_ON_FULL``,
``TM_TPU_SERVE_QUEUE_TIMEOUT_S``, ``TM_TPU_SERVE_STAGING_SLOTS``. A malformed or
out-of-range env value degrades to the field default with a ONE-SHOT rank-zero warning
(the warning cache dedups by message) — a typo'd deployment knob must not crash the
service at its first enqueue.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Optional, Type

from torchmetrics_tpu_torch.utils.exceptions import ServeError
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

ENV_SERVE_MAX_INFLIGHT = "TM_TPU_SERVE_MAX_INFLIGHT"
ENV_SERVE_ON_FULL = "TM_TPU_SERVE_ON_FULL"
ENV_SERVE_QUEUE_TIMEOUT = "TM_TPU_SERVE_QUEUE_TIMEOUT_S"
ENV_SERVE_STAGING_SLOTS = "TM_TPU_SERVE_STAGING_SLOTS"
ENV_SERVE_COALESCE = "TM_TPU_SERVE_COALESCE"
ENV_SERVE_LINGER = "TM_TPU_SERVE_LINGER_MS"

_ON_FULL = ("block", "raise", "shed")


@dataclass(frozen=True)
class ServeOptions:
    """Policy for one :class:`~torchmetrics_tpu_torch.serve.engine.IngestEngine`.

    ``max_inflight`` bounds enqueued-but-uncommitted batches (the in-flight window,
    including the batch the drain thread is currently applying). ``queue_timeout_s``
    caps how long one blocking enqueue may park. ``staging_slots`` sizes the
    double-buffered host→device staging pipeline (transfer-ahead depth).
    ``restart_drain`` lets quiesce revive a dead drain thread (the drain-thread-death
    recovery latch); turning it off makes thread death a hard :class:`ServeError`.
    """

    max_inflight: int = 64
    on_full: str = "block"
    queue_timeout_s: float = 30.0
    staging_slots: int = 2
    #: drain-side batch coalescing: when the window holds several consecutive batches of
    #: the same shape signature, the drain folds up to this many through ONE
    #: ``update_batches`` step (one graph replay on the card) instead of one dispatch each — the structural
    #: throughput win a synchronous per-batch loop cannot have (k dispatches → 1,
    #: bit-identical by the tier-equivalence contract). 1 disables coalescing.
    coalesce: int = 16
    #: micro-batching dwell (milliseconds): with a short queue the drain waits up to
    #: this long for more same-shape batches before launching, so steady high-rate
    #: traffic coalesces instead of degenerating into per-batch launches that fight
    #: the enqueueing thread for the GIL (the Nagle tradeoff: + linger on commit
    #: latency, x coalesce on drain throughput). 0 launches immediately. Quiesce and
    #: close bypass the linger — a waiting reader never pays it.
    linger_ms: float = 0.0
    restart_drain: bool = True

    def __post_init__(self) -> None:
        if int(self.max_inflight) < 1:
            raise ServeError(f"ServeOptions(max_inflight) needs >= 1, got {self.max_inflight}")
        if int(self.coalesce) < 1:
            raise ServeError(f"ServeOptions(coalesce) needs >= 1, got {self.coalesce}")
        if float(self.linger_ms) < 0:
            raise ServeError(f"ServeOptions(linger_ms) needs >= 0, got {self.linger_ms}")
        if self.on_full not in _ON_FULL:
            raise ServeError(
                f"ServeOptions(on_full) must be one of {_ON_FULL}, got {self.on_full!r}"
            )
        if float(self.queue_timeout_s) < 0:
            raise ServeError(
                f"ServeOptions(queue_timeout_s) needs >= 0, got {self.queue_timeout_s}"
            )
        if int(self.staging_slots) < 1:
            raise ServeError(f"ServeOptions(staging_slots) needs >= 1, got {self.staging_slots}")


def _env_num(name: str, default: Any, cast: Type,
             valid: Optional[Callable[[Any], bool]] = None) -> Any:
    """Read a numeric env knob; degrade to ``default`` on malformed/out-of-range values.

    The degradation warns rank-zero exactly once per (knob, bad value) — the warning
    cache dedups by message — so a typo'd ``TM_TPU_SERVE_*`` in a deployment manifest
    is loud in the logs but never crashes the service at its first enqueue.
    """
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = cast(float(raw)) if cast is int else cast(raw)
    except (TypeError, ValueError):
        rank_zero_warn(
            f"Ignoring malformed env {name}={raw!r} (not a {cast.__name__});"
            f" using the default {default!r}.",
            UserWarning,
        )
        return default
    if valid is not None and not valid(value):
        rank_zero_warn(
            f"Ignoring out-of-range env {name}={raw!r}; using the default {default!r}.",
            UserWarning,
        )
        return default
    return value


def serve_options_from_env() -> ServeOptions:
    """Build :class:`ServeOptions` from the ``TM_TPU_SERVE_*`` environment knobs.

    Malformed or out-of-range values degrade to the field defaults with a one-shot
    rank-zero warning per knob — they never raise.
    """
    on_full = str(os.environ.get(ENV_SERVE_ON_FULL, "block")).strip().lower()
    if on_full not in _ON_FULL:
        rank_zero_warn(
            f"Ignoring unknown env {ENV_SERVE_ON_FULL}={on_full!r} (valid: {_ON_FULL});"
            " using the default 'block'.",
            UserWarning,
        )
        on_full = "block"
    return ServeOptions(
        max_inflight=_env_num(ENV_SERVE_MAX_INFLIGHT, 64, int, lambda v: v >= 1),
        on_full=on_full,
        queue_timeout_s=_env_num(ENV_SERVE_QUEUE_TIMEOUT, 30.0, float, lambda v: v >= 0),
        staging_slots=_env_num(ENV_SERVE_STAGING_SLOTS, 2, int, lambda v: v >= 1),
        coalesce=_env_num(ENV_SERVE_COALESCE, 16, int, lambda v: v >= 1),
        linger_ms=_env_num(ENV_SERVE_LINGER, 0.0, float, lambda v: v >= 0),
    )
