"""User-facing exception types (counterpart of ``torchmetrics_tpu/utils/exceptions.py``)."""


class TorchMetricsUserError(Exception):
    """Error raised on wrong usage of the metric API."""
