"""User-facing exception types (counterpart of ``torchmetrics_tpu/utils/exceptions.py``)."""


class TorchMetricsUserError(Exception):
    """Error raised on wrong usage of the metric API."""


class TorchMetricsUserWarning(UserWarning):
    """Warning raised on questionable usage of the metric API."""


class NumericPoisonError(TorchMetricsUserError):
    """Raised at ``compute()`` when ``nan_policy="raise"`` counted non-finite inputs.

    The count itself is taken inside the update, on the device (a poison-counter state accumulated
    beside the metric's own), so ``update`` and ``forward`` never read the host; the one host read
    happens here, at finalisation.
    """


class SnapshotError(TorchMetricsUserError):
    """Raised when a metric state snapshot cannot be taken or restored.

    Covers snapshots while a graph step is writing the state, snapshots with batches pending in a
    buffered accumulator, and restores of blobs that fail format, version, CRC or shape validation.
    """


class SyncTimeoutError(TorchMetricsUserError):
    """Raised when a bounded multi-process sync exhausts its deadline and retries (JAX ``exceptions.py:33``).

    Only raised when degraded mode is off; with ``degraded_mode=True`` the sync instead falls back to local
    state and marks the result non-world-consistent.

    ``responses`` optionally carries the partial per-rank responses (``{rank: value}``) that DID arrive before
    the deadline: a quorum-capable gather attaches them so the sync layer can aggregate over the responding
    subset instead of dropping to local-only state (``SyncOptions(quorum=...)``).
    """

    def __init__(self, *args, responses=None):
        super().__init__(*args)
        self.responses = responses


class JournalError(TorchMetricsUserError):
    """Raised when a write-ahead update journal cannot be appended, read, or replayed.

    Covers corrupted (CRC), truncated-mid-stream, or structurally alien journal records; a torn TAIL
    record (a crash mid-append on a filesystem that lost the rename) is tolerated with a warning
    instead, see ``torchmetrics_tpu_torch.robust.journal``.
    """


class ReconciliationError(TorchMetricsUserError):
    """Raised when a rank re-admission handshake blob fails validation.

    The reconciliation offer wraps a merged snapshot; accepting it into a metric whose registered
    states or class do not match, or from an incompatible format version, fails loudly instead of
    silently merging mismatched state.
    """


class ServeError(TorchMetricsUserError):
    """Raised by the async ingestion tier (``torchmetrics_tpu_torch.serve``) on engine faults.

    Covers a drain thread that died and could not be restarted, an enqueued batch whose
    deferred apply failed (surfaced at the next quiesce so ``compute()`` can never
    silently miss a committed-looking batch), and invalid ``ServeOptions``.
    """


class BackpressureError(ServeError):
    """Raised when the bounded in-flight window rejects an ``update_async`` enqueue.

    Fired immediately with ``ServeOptions(on_full="raise")``, or after
    ``queue_timeout_s`` of blocking with ``on_full="block"``. With ``on_full="shed"``
    the batch is dropped-and-counted instead and no exception is raised.
    """


class BundleError(TorchMetricsUserError):
    """Raised when a post-mortem flight bundle fails capture-time or read-time validation.

    Covers files that are not bundles (bad magic/truncated header), container or
    per-section CRC mismatches, unknown format versions, and bundles missing required
    sections, see ``torchmetrics_tpu_torch.obs.bundle``.
    """
