"""Declarative SLO specs with multi-window burn-rate evaluation over registry series (counterpart
of ``torchmetrics_tpu/obs/slo.py``).

An :class:`SloSpec` names one live series (:meth:`Telemetry.series`), what makes a sample *bad*,
and the multi-window burn-rate policy; an :class:`SloMonitor` evaluates a set of specs on demand.
With error budget ``1 - objective``, the **burn rate** over a window is ``error_rate / budget``;
an alarm needs the burn threshold exceeded in EVERY configured window (long window = sustained,
short window = still happening).

- ``series``: the registry series the objective reads; **sample mode** judges each recorded value
  against ``threshold``/``bad_when``.
- ``ratio_of``: **event-ratio mode**: ``series`` counts bad events, ``ratio_of`` all events, and
  the error rate is bad-rate over total-rate per window.
- ``windows``: ``(window_seconds, burn_threshold)`` pairs, every one of which must burn hot.

Firing shows three ways: a ``rank_zero_warn`` on each transition into burning, the ``slo.alarms``
/ ``slo.alarms.<name>`` counters, and a ``slo.<name>.burn_rate`` gauge; each transition, either
way, is a flight-recorder event. Everything here is host Python over host points.

    >>> from torchmetrics_tpu_torch.obs.telemetry import Telemetry
    >>> t = Telemetry(enabled=False)
    >>> s = t.series("demo.latency_us")
    >>> for i in range(100):
    ...     s.record(10_000.0 if i % 2 else 10.0, now=100.0 + i / 100.0)
    >>> spec = SloSpec(name="enqueue-p99", series="demo.latency_us", objective=0.99,
    ...                threshold=5_000.0, windows=((1.0, 1.0), (10.0, 1.0)))
    >>> status = SloMonitor([spec], registry=t).evaluate(now=101.0)[0]
    >>> status.burning, status.worst_burn >= 1.0
    (True, True)
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from torchmetrics_tpu_torch.obs.telemetry import Telemetry, telemetry
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = [
    "SloSpec", "SloStatus", "SloMonitor", "default_drift_specs", "default_serve_specs", "default_fleet_specs",
]

#: default multi-window policy: sustained over 5 minutes AND still burning over the last 30
#: seconds, both at >= 2x budget pace
DEFAULT_WINDOWS: Tuple[Tuple[float, float], ...] = ((30.0, 2.0), (300.0, 2.0))


@dataclass(frozen=True)
class SloSpec:
    """One service-level objective over a registry series (see the module docstring)."""

    name: str
    series: str
    objective: float = 0.999
    threshold: float = 0.0
    bad_when: str = "above"             # "above" | "below" (sample mode only)
    ratio_of: Optional[str] = None      # event-ratio mode: total-events series
    windows: Tuple[Tuple[float, float], ...] = DEFAULT_WINDOWS
    description: str = ""
    #: "process" specs read this process's own series; "fleet" specs read a fleet registry's
    scope: str = "process"

    def __post_init__(self) -> None:
        if not (0.0 < self.objective < 1.0):
            raise ValueError(f"SloSpec(objective) needs (0, 1), got {self.objective}")
        if self.bad_when not in ("above", "below"):
            raise ValueError(f"SloSpec(bad_when) must be 'above'|'below', got {self.bad_when!r}")
        if self.scope not in ("process", "fleet"):
            raise ValueError(f"SloSpec(scope) must be 'process'|'fleet', got {self.scope!r}")
        if not self.windows:
            raise ValueError("SloSpec(windows) needs at least one (window_s, burn) pair")
        for w, b in self.windows:
            if w <= 0 or b <= 0:
                raise ValueError(f"SloSpec window ({w}, {b}) needs positive entries")

    @property
    def budget(self) -> float:
        """Error budget: the bad fraction the objective tolerates."""
        return 1.0 - self.objective


@dataclass
class SloStatus:
    """One evaluation result: per-window error and burn rates, and the alarm verdict."""

    spec: SloSpec
    burning: bool
    worst_burn: float
    burn_rates: Dict[float, Optional[float]] = field(default_factory=dict)
    error_rates: Dict[float, Optional[float]] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.spec.name,
            "series": self.spec.series,
            "burning": self.burning,
            "worst_burn": round(self.worst_burn, 3),
            "burn_rates": {str(w): (None if b is None else round(b, 3)) for w, b in self.burn_rates.items()},
            "error_rates": {str(w): (None if e is None else round(e, 4)) for w, e in self.error_rates.items()},
        }


class SloMonitor:
    """Evaluates a set of :class:`SloSpec` against a telemetry registry (the global one by default)."""

    def __init__(self, specs: Sequence[SloSpec] = (), registry: Optional[Telemetry] = None) -> None:
        self.specs: List[SloSpec] = list(specs)
        self._tel = registry if registry is not None else telemetry
        self._burning: Dict[str, bool] = {}

    def watch(self, spec: SloSpec) -> "SloMonitor":
        self.specs.append(spec)
        return self

    # ------------------------------------------------------------------ evaluation
    def _error_rate(self, spec: SloSpec, window_s: float, now: Optional[float]) -> Optional[float]:
        series = self._tel.get_series(spec.series)
        if series is None:
            return None
        if spec.ratio_of is not None:
            total = self._tel.get_series(spec.ratio_of)
            if total is None:
                return None
            total_rate = total.rate_over(window_s, now=now)
            if total_rate <= 0:
                return None  # no traffic in the window: no evidence either way
            return min(1.0, series.rate_over(window_s, now=now) / total_rate)
        return series.bad_fraction_over(window_s, spec.threshold, spec.bad_when, now=now)

    def evaluate(self, now: Optional[float] = None) -> List[SloStatus]:
        """Evaluate every spec; fires alarms (warning, counters, gauges) on transition.

        ``now`` pins the evaluation clock (monotonic domain) for tests and synthetic series. A
        window with no samples contributes ``None`` and cannot satisfy the alarm: silence is not
        burn.
        """
        self._tel.counter("slo.evaluations").inc()
        out: List[SloStatus] = []
        eval_now = time.monotonic() if now is None else now
        for spec in self.specs:
            burns: Dict[float, Optional[float]] = {}
            errs: Dict[float, Optional[float]] = {}
            alarm = True
            worst = 0.0
            for window_s, burn_threshold in spec.windows:
                err = self._error_rate(spec, window_s, eval_now)
                errs[window_s] = err
                burn = None if err is None else err / spec.budget
                burns[window_s] = burn
                if burn is None or burn < burn_threshold:
                    alarm = False
                if burn is not None:
                    worst = max(worst, burn)
            self._tel.gauge(f"slo.{spec.name}.burn_rate").set(worst)
            was = self._burning.get(spec.name, False)
            if alarm != was:
                # alarm TRANSITIONS (both directions) are flight-ring events
                from torchmetrics_tpu_torch.obs import flightrec as _flightrec

                _flightrec.record("slo.alarm", name=spec.name, series=spec.series, burning=alarm,
                                  worst_burn=round(worst, 3))
            if alarm:
                self._tel.counter("slo.alarms").inc()
                self._tel.counter(f"slo.alarms.{spec.name}").inc()
                if not was:
                    rank_zero_warn(
                        f"SLO '{spec.name}' burning: series {spec.series!r} error budget"
                        f" ({spec.budget:.4g}) is being consumed at {worst:.1f}x the"
                        f" objective pace across all configured windows"
                        f" ({', '.join(f'{w:g}s' for w, _ in spec.windows)})."
                        + (f" {spec.description}" if spec.description else ""),
                        UserWarning,
                    )
            self._burning[spec.name] = alarm
            if self._tel.enabled:
                self._tel.event(f"slo.{spec.name}", ph="i", cat="slo",
                                args={"burning": alarm, "worst_burn": round(worst, 3)})
            out.append(SloStatus(spec=spec, burning=alarm, worst_burn=worst, burn_rates=burns, error_rates=errs))
        return out

    def burning(self) -> List[str]:
        """Names of specs whose last evaluation fired."""
        return sorted(n for n, b in self._burning.items() if b)

    # ------------------------------------------------------------ adaptive-serve feed
    def signals(self, window_s: float = 30.0, now: Optional[float] = None) -> Dict[str, Any]:
        """The live queue-pressure numbers of the ``serve.*`` series: queue depth (last, p50,
        p99), in-flight occupancy, commit/enqueue/shed rates over ``window_s``, the shed ratio and
        the enqueue-to-commit latency quantiles. Missing series yield None entries (the port has
        no serving engine yet, so these stay None unless a caller records the series)."""
        out: Dict[str, Any] = {"window_s": window_s}
        depth = self._tel.get_series("serve.queue_depth")
        if depth is not None and depth.count:
            p50, p99 = depth.quantiles((0.5, 0.99))
            out.update({"queue_depth_last": depth.last, "queue_depth_p50": p50, "queue_depth_p99": p99})
        inflight = self._tel.get_series("serve.inflight")
        if inflight is not None:
            out["inflight_last"] = inflight.last
        for key, series in (("commit_rate", "serve.commits"),
                            # queue_depth has one point per offered batch: its event rate is the enqueue rate
                            ("enqueue_rate", "serve.queue_depth"),
                            ("shed_rate", "serve.sheds")):
            s = self._tel.get_series(series)
            out[key] = None if s is None else round(s.rate_over(window_s, now=now), 3)
        if out.get("enqueue_rate") and out.get("shed_rate") is not None:
            out["shed_ratio"] = round(out["shed_rate"] / out["enqueue_rate"], 4)
        else:
            out["shed_ratio"] = None
        lat = self._tel.get_series("serve.commit_latency_us")
        if lat is not None and lat.count:
            p50, p99 = lat.quantiles((0.5, 0.99))
            out.update({"commit_latency_us_p50": p50, "commit_latency_us_p99": p99})
        return out


def default_serve_specs(
    latency_objective: float = 0.99,
    latency_threshold_us: float = 50_000.0,
    shed_objective: float = 0.999,
    windows: Tuple[Tuple[float, float], ...] = DEFAULT_WINDOWS,
) -> List[SloSpec]:
    """The serving tier's stock SLOs, as plain spec data: enqueue-to-commit latency and shed ratio."""
    return [
        SloSpec(
            name="commit-latency", series="serve.commit_latency_us",
            objective=latency_objective, threshold=latency_threshold_us,
            bad_when="above", windows=windows,
            description="enqueue->commit latency budget (docs/serving.md)",
        ),
        SloSpec(
            # serve.queue_depth records one point per OFFERED batch: the shed ratio's denominator
            name="shed-ratio", series="serve.sheds", ratio_of="serve.queue_depth",
            objective=shed_objective, windows=windows,
            description="shed batches vs offered batches (on_full='shed' pressure)",
        ),
    ]


def default_fleet_specs(
    shed_budget: float = 0.001,
    poll_objective: float = 0.99,
    windows: Tuple[Tuple[float, float], ...] = DEFAULT_WINDOWS,
) -> List[SloSpec]:
    """Fleet-scoped stock SLOs, as plain spec data, over the series a fleet federator records
    per poll (``fleet.shed_ratio``, ``fleet.peers_unhealthy``)."""
    return [
        SloSpec(
            name="fleet-shed-storm", series="fleet.shed_ratio",
            objective=poll_objective, threshold=shed_budget, bad_when="above",
            windows=windows, scope="fleet",
            description="fleet-wide shed batches vs offered batches (federated)",
        ),
        SloSpec(
            name="fleet-peers-healthy", series="fleet.peers_unhealthy",
            objective=poll_objective, threshold=0.0, bad_when="above",
            windows=windows, scope="fleet",
            description="federation polls finding unreachable/stale peers",
        ),
    ]


def default_drift_specs(metric: Any, reference: Any, **kwargs: Any) -> list:
    """The model-quality twin of :func:`default_serve_specs`: stock drift alarms (KS and PSI,
    sketch to sketch against ``reference``) for a windowed, sketch-backed metric. Delegates to
    :func:`torchmetrics_tpu_torch.online.drift.default_drift_specs`; drive the result with a
    :class:`~torchmetrics_tpu_torch.online.drift.DriftMonitor`."""
    from torchmetrics_tpu_torch.online.drift import default_drift_specs as _impl

    return _impl(metric, reference, **kwargs)
