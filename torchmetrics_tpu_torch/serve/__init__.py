"""Non-blocking serving tier: ``update_async`` with bounded backpressure (counterpart of
``torchmetrics_tpu/serve``).

Opt-in per metric or collection: ``metric.serve(ServeOptions(...), journal=...)`` configures the engine,
``metric.update_async(*batch)`` enqueues and returns an :class:`IngestTicket`. The disabled path costs one
attribute check per update. Every host read (``compute``, ``metric_state``, ``snapshot``, ``sync``,
``reset``, a synchronous ``update``/``forward``) quiesces the window first. ``metric.serve(control=True)``
attaches the adaptive :class:`ServeController`; :class:`SharedDrain` serves many engines from one thread.
"""
from torchmetrics_tpu_torch.serve.control import (
    ControlOptions,
    DriftSnapshotter,
    ServeController,
    SharedDrain,
    adaptive_recover,
    control_options_from_env,
    shed_seqs,
)
from torchmetrics_tpu_torch.serve.engine import DrainKilled, IngestEngine, IngestTicket
from torchmetrics_tpu_torch.serve.options import (
    ENV_SERVE_MAX_INFLIGHT,
    ENV_SERVE_ON_FULL,
    ENV_SERVE_QUEUE_TIMEOUT,
    ENV_SERVE_STAGING_SLOTS,
    ServeOptions,
    serve_options_from_env,
)
from torchmetrics_tpu_torch.serve.staging import StagingPipeline

__all__ = [
    "ControlOptions",
    "DrainKilled",
    "DriftSnapshotter",
    "IngestEngine",
    "IngestTicket",
    "ServeController",
    "ServeOptions",
    "SharedDrain",
    "StagingPipeline",
    "adaptive_recover",
    "control_options_from_env",
    "serve_options_from_env",
    "shed_seqs",
    "ENV_SERVE_MAX_INFLIGHT",
    "ENV_SERVE_ON_FULL",
    "ENV_SERVE_QUEUE_TIMEOUT",
    "ENV_SERVE_STAGING_SLOTS",
]
