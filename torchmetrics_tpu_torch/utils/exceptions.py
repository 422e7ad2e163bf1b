"""User-facing exception types (counterpart of ``torchmetrics_tpu/utils/exceptions.py``)."""


class TorchMetricsUserError(Exception):
    """Error raised on wrong usage of the metric API."""


class TorchMetricsUserWarning(UserWarning):
    """Warning raised on questionable usage of the metric API."""
