"""torchmetrics_tpu_torch.obs: runtime telemetry of the port's metric engine (counterpart of
``torchmetrics_tpu.obs``).

Per-metric ``update``/``forward``/``compute`` call counts and wall times, graph-capture
(retrace) counters with the capture-churn detector, device-step (dispatch) counts, the always-on
flight recorder, live time series with KLL quantiles, and the SLO burn-rate monitor::

    from torchmetrics_tpu_torch import obs

    with obs.enabled():              # or: TM_TPU_TELEMETRY=1 in the environment
        metric.update(preds, target)
        metric.compute()
    print(metric.telemetry)          # per-instance calls / captures / dispatches

Cost model: *counting* is always on (integer bumps in host Python); *tracing* (events, spans,
timers) records only while enabled and goes through a shared null scope otherwise. Nothing here
runs inside a captured graph.

This module exports the names of ``torchmetrics_tpu.obs.__all__`` that its ported modules
(``telemetry``, ``flightrec``, ``timeseries``, ``slo``) define; the exporters, the profilers, the
memory ledger, bundles and federation are not ported yet (ROADMAP.md, queue A, item 9).
"""
from torchmetrics_tpu_torch.obs import flightrec, slo, timeseries  # noqa: F401
from torchmetrics_tpu_torch.obs.flightrec import adopt_incident, current_incident, open_incident
from torchmetrics_tpu_torch.obs.slo import (
    SloMonitor,
    SloSpec,
    default_drift_specs,
    default_fleet_specs,
    default_serve_specs,
)
from torchmetrics_tpu_torch.obs.telemetry import (
    ENV_FLAG,
    ENV_RETRACE_THRESHOLD,
    Counter,
    Gauge,
    Histogram,
    Telemetry,
    Timer,
    bump,
    count_dispatch,
    describe_abstract,
    device_sync,
    disable,
    enable,
    enabled,
    instrument_trace,
    is_enabled,
    metric_span,
    process_fingerprint,
    record_trace,
    retrace_warn_threshold,
    set_retrace_warn_threshold,
    telemetry,
    tree_bytes,
)
from torchmetrics_tpu_torch.obs.timeseries import TimeSeries

__all__ = [
    "ENV_FLAG",
    "ENV_RETRACE_THRESHOLD",
    "Counter",
    "Gauge",
    "Histogram",
    "SloMonitor",
    "SloSpec",
    "Telemetry",
    "TimeSeries",
    "Timer",
    "adopt_incident",
    "bump",
    "count_dispatch",
    "current_incident",
    "default_drift_specs",
    "default_fleet_specs",
    "default_serve_specs",
    "describe_abstract",
    "device_sync",
    "disable",
    "enable",
    "enabled",
    "flightrec",
    "instrument_trace",
    "is_enabled",
    "metric_span",
    "open_incident",
    "process_fingerprint",
    "record_trace",
    "retrace_warn_threshold",
    "set_retrace_warn_threshold",
    "slo",
    "telemetry",
    "timeseries",
    "tree_bytes",
]
