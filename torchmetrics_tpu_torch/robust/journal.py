"""Preemption-safe write-ahead journal of metric update batches (counterpart of
``torchmetrics_tpu/robust/journal.py``).

A durable snapshot (``robust/checkpoint.py``) holds the state at one instant; every update after it dies
with the process. The journal closes the gap with the write-ahead contract: every update batch is
appended to disk, atomically and checksummed, *before* it is applied, so a preempted process restores
``snapshot + replay(journal)`` instead of losing the tail of the epoch.

Replay drives the ordinary ``update`` on the metric's device, whatever tier first applied the records, and
gives the uninterrupted run's bits where the update is deterministic: the graph and eager tiers are
bit-equal, and the kernels on a replayed update must add in a fixed order or exactly. K1 (``bincount``),
K3 (``curve_counts``) and K2's ``sketch_update`` are; K2's ``hist_pair`` with general float weights and
``index_add_`` over unsorted ids are not (ROADMAP.md, queue B, "Determinism"), so a metric that reaches
them replays to within their last bits.

Layout of a journal directory::

    <dir>/snapshot.tmsnap      durable state snapshot (atomic, doubly CRC'd)
    <dir>/000000000042.tmj     one record per appended batch, named by sequence number
    <dir>/.writer.lock         O_EXCL exclusive-writer lock: "<pid>:<token>"; a second live
                               MetricJournal on the same directory raises JournalError; a dead
                               holder's lock is stale and stolen with a warning, and
                               recover()/break_lock() force-release it

Record container: ``TMJR1\\n`` magic + little-endian ``(crc32, length)`` + pickled ``{"seq", "args",
"kwargs"}`` with every array leaf as host numpy, the JAX package's format, so a journal that it writes
replays here. Records are written by temp file + ``os.replace`` + fsync of the file and the directory, so a
record exists completely or not at all; a torn TAIL record is skipped with a warning, while corruption
anywhere earlier raises :class:`~torchmetrics_tpu_torch.utils.exceptions.JournalError`.

The journal is **bounded**: :class:`MetricJournal` (``Metric.journal(dir, every_k)``) takes a durable
snapshot every ``every_k`` appends and truncates the prefix it covers. It also plugs into the buffered
seam: ``metric.buffered(k, journal=...)`` (or ``MetricJournal.buffered``) journals each batch at ``update``
time, so the batches pending in a :class:`~torchmetrics_tpu_torch.ops.dispatch.BufferedUpdater` survive a
preemption that strikes before the flush.

``MetricJournal.update_async`` wires the journal into the metric's ingestion engine (``serve/``), which appends
at ENQUEUE time; a replay cursor is a sequence number, a cursor dict, a post-mortem bundle document or a bundle
file's path (``obs/bundle``), so replay stops at the captured instant.
"""
from __future__ import annotations

import os
import pickle
import struct
import uuid
import zlib
from typing import Any, Collection, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
from torch import Tensor
from torch.utils._pytree import tree_flatten, tree_unflatten

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.robust import checkpoint as _checkpoint
from torchmetrics_tpu_torch.utils.exceptions import JournalError
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

MAGIC = b"TMJR1\n"
RECORD_SUFFIX = ".tmj"
SNAPSHOT_FILENAME = "snapshot.tmsnap"
LOCK_FILENAME = ".writer.lock"
_HEADER = struct.Struct("<IQ")

#: most recent journal activity in this process: the cursor a post-mortem bundle records, so that replay
#: can stop at the captured instant
_LAST_CURSOR: Optional[Dict[str, Any]] = None


def _note_cursor(path: str, last_seq: int) -> None:
    global _LAST_CURSOR
    _LAST_CURSOR = {
        "path": path,
        "last_seq": int(last_seq),
        "snapshot_present": os.path.exists(os.path.join(path, SNAPSHOT_FILENAME)),
    }


def last_cursor() -> Optional[Dict[str, Any]]:
    """The latest journal cursor this process touched (None before any append)."""
    return None if _LAST_CURSOR is None else dict(_LAST_CURSOR)


def _cursor_seq(cursor: Any) -> Optional[int]:
    """Normalise a replay cursor: an int, a cursor dict, a bundle document, or a bundle path."""
    if cursor is None:
        return None
    if isinstance(cursor, int):
        return cursor
    if isinstance(cursor, (str, os.PathLike)):
        from torchmetrics_tpu_torch.obs.bundle import load_bundle

        cursor = load_bundle(cursor, strict=False)
    if isinstance(cursor, dict):
        if "sections" in cursor:  # a full bundle document
            cursor = (cursor["sections"].get("journal") or {}).get("cursor") or {}
        if "last_seq" in cursor:
            return int(cursor["last_seq"])
    raise JournalError(
        f"Unusable journal cursor {cursor!r}: pass a sequence number, a bundle's"
        " journal cursor dict, a bundle document, or a bundle path."
    )


def _pid_alive(pid: int) -> bool:
    """Best-effort liveness probe; a pid we may not signal is assumed alive."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):  # exists but not ours
        return True
    return True


class _WriterLock:
    """``O_EXCL`` lockfile guarding a journal directory against a second live writer.

    Two :class:`MetricJournal` proxies appending to one directory would interleave their sequence numbers
    silently. The lockfile holds ``"<pid>:<token>"``: a conflicting open raises :class:`JournalError` naming
    the holder's pid; a lock whose holder pid is dead is stale and stolen with a warning; release unlinks
    only while the token still matches, so a released-then-stolen lock is never deleted from under its new
    holder.
    """

    def __init__(self, dirpath: str) -> None:
        self.path = os.path.join(dirpath, LOCK_FILENAME)
        self.token = uuid.uuid4().hex
        self.held = False

    def _read_holder(self) -> Tuple[Optional[int], str]:
        try:
            with open(self.path, "r", encoding="utf-8") as fh:
                raw = fh.read().strip()
        except OSError:
            return None, ""
        pid_s, _, token = raw.partition(":")
        try:
            return int(pid_s), token
        except ValueError:
            return None, token

    def acquire(self) -> None:
        payload = f"{os.getpid()}:{self.token}".encode()
        for attempt in (0, 1):
            try:
                fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o644)
            except FileExistsError:
                holder_pid, _ = self._read_holder()
                if attempt == 0 and (holder_pid is None or not _pid_alive(holder_pid)):
                    rank_zero_warn(
                        f"Stealing stale journal writer lock {self.path!r}"
                        f" (holder pid {holder_pid} is gone).",
                        UserWarning,
                    )
                    try:
                        os.unlink(self.path)
                    except OSError:  # raced another stealer
                        pass
                    continue
                raise JournalError(
                    f"Journal dir {os.path.dirname(self.path)!r} already has a live"
                    f" writer (pid {holder_pid}). Two writers appending to one journal"
                    " interleave records silently; close() the other MetricJournal"
                    " first, or recover()/break_lock() if that process is dead."
                )
            try:
                os.write(fd, payload)
                os.fsync(fd)
            finally:
                os.close(fd)
            self.held = True
            return

    def release(self) -> None:
        if not self.held:
            return
        self.held = False
        holder_pid, token = self._read_holder()
        if holder_pid == os.getpid() and token == self.token:
            try:
                os.unlink(self.path)
            except OSError:  # already gone
                pass


def break_lock(path: Union[str, os.PathLike]) -> bool:
    """Force-release a journal directory's writer lock; True when a lock was removed. For recovery only:
    it asserts that the previous writer is dead (``recover`` calls it)."""
    lock_path = os.path.join(os.fspath(path), LOCK_FILENAME)
    try:
        os.unlink(lock_path)
        return True
    except OSError:
        return False


def _host_tree(value: Any) -> Any:
    """A batch pytree with every tensor leaf copied to host numpy (the tensors read in one transfer per
    device) and numbers as numpy scalars, as the JAX package stores them."""
    leaves, spec = tree_flatten(value)
    tensors = [i for i, leaf in enumerate(leaves) if isinstance(leaf, Tensor)]
    host = list(leaves)
    for i, arr in zip(tensors, _checkpoint.host_arrays([leaves[i] for i in tensors])):
        host[i] = arr
    for i, leaf in enumerate(host):
        if isinstance(leaf, (int, float, bool, complex)) or (hasattr(leaf, "shape") and not isinstance(leaf, np.ndarray)):
            host[i] = np.asarray(leaf)
    return tree_unflatten(host, spec)


class Journal:
    """Append-only, CRC-checksummed, crash-atomic record log of update batches.

    ``append`` is write-ahead durable: when it returns, the batch is on disk. ``read`` yields the surviving
    records in sequence order with full validation. ``truncate_through`` drops the prefix a durable snapshot
    already covers.
    """

    def __init__(self, path: Union[str, os.PathLike], max_pending: int = 65536) -> None:
        self.path = os.fspath(path)
        self.max_pending = int(max_pending)
        os.makedirs(self.path, exist_ok=True)
        existing = self._record_seqs()
        self._next_seq = (existing[-1] + 1) if existing else 0

    def _record_seqs(self) -> List[int]:
        seqs = []
        for fname in os.listdir(self.path):
            if fname.endswith(RECORD_SUFFIX) and not fname.startswith("."):
                try:
                    seqs.append(int(fname[: -len(RECORD_SUFFIX)]))
                except ValueError:
                    continue
        return sorted(seqs)

    def _record_path(self, seq: int) -> str:
        return os.path.join(self.path, f"{seq:012d}{RECORD_SUFFIX}")

    @property
    def pending(self) -> int:
        """Records currently on disk (appended since the last truncation)."""
        return len(self._record_seqs())

    @property
    def last_seq(self) -> int:
        """Sequence number of the most recently appended record; -1 before any append."""
        return self._next_seq - 1

    def append(self, args: Tuple = (), kwargs: Optional[Dict[str, Any]] = None) -> int:
        """Durably journal one update batch; returns its sequence number.

        The record is on disk (fsync'd, atomically named) before this returns. The batch's tensors are
        copied to host numpy, so a later in-place write cannot change the journaled payload.
        """
        seq = self._next_seq
        payload = pickle.dumps(
            {"seq": seq, "args": _host_tree(tuple(args)), "kwargs": _host_tree(dict(kwargs or {}))},
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        data = MAGIC + _HEADER.pack(zlib.crc32(payload) & 0xFFFFFFFF, len(payload)) + payload
        _checkpoint.atomic_write_bytes(self._record_path(seq), data)
        self._next_seq = seq + 1
        obs.telemetry.counter("robust.journal_appends").inc()
        obs.flightrec.record("journal.append", seq=seq, path=self.path)
        _note_cursor(self.path, seq)
        if self.max_pending and (seq % 64 == 0) and self.pending > self.max_pending:
            rank_zero_warn(
                f"Update journal at {self.path!r} holds {self.pending} records, beyond its"
                f" {self.max_pending}-record bound: no durable snapshot is truncating it."
                " Take snapshots (Metric.journal(every_k=...) does this automatically) or"
                " replay will grow unboundedly expensive.",
                UserWarning,
            )
        return seq

    def _decode(self, seq: int, is_tail: bool) -> Optional[Tuple[int, tuple, dict]]:
        path = self._record_path(seq)
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
        except OSError as err:
            raise JournalError(f"Cannot read journal record {path!r}: {err}") from err
        header_len = len(MAGIC) + _HEADER.size
        problem = None
        if len(raw) < header_len or not raw.startswith(MAGIC):
            problem = "bad magic/truncated header"
        else:
            crc, length = _HEADER.unpack(raw[len(MAGIC):header_len])
            payload = raw[header_len:]
            if len(payload) != length:
                problem = f"payload truncated ({len(payload)} of {length} bytes)"
            elif zlib.crc32(payload) & 0xFFFFFFFF != crc:
                problem = "checksum mismatch"
        if problem is not None:
            if is_tail:
                # a crash mid-append can only tear the newest record; losing the batch that was being
                # written when the process died is the honest outcome
                obs.flightrec.record("journal.torn_tail", seq=seq, problem=problem)
                rank_zero_warn(
                    f"Journal tail record {path!r} is torn ({problem}); skipping it."
                    " The batch being appended at the crash is not recoverable.",
                    UserWarning,
                )
                return None
            # a mid-stream hole is unrecoverable: bundle the evidence before failing
            obs.flightrec.record("journal.corrupt", seq=seq, problem=problem, path=self.path)
            obs.capture_bundle("journal_corrupt")
            raise JournalError(
                f"Journal record {path!r} is corrupt ({problem}) with later records"
                " present — the stream has a hole and cannot be replayed faithfully."
            )
        rec = pickle.loads(payload)
        if not isinstance(rec, dict) or rec.get("seq") != seq:
            raise JournalError(f"Journal record {path!r} does not match its sequence number")
        return seq, tuple(rec.get("args", ())), dict(rec.get("kwargs", {}))

    def read(self, after_seq: int = -1) -> Iterator[Tuple[int, tuple, dict]]:
        """Yield validated ``(seq, args, kwargs)`` records with ``seq > after_seq``, in order."""
        seqs = [s for s in self._record_seqs() if s > after_seq]
        for i, seq in enumerate(seqs):
            rec = self._decode(seq, is_tail=(i == len(seqs) - 1))
            if rec is not None:
                yield rec

    def truncate_through(self, seq: int) -> int:
        """Drop records with sequence ≤ ``seq`` (covered by a durable snapshot)."""
        dropped = 0
        for s in self._record_seqs():
            if s <= seq:
                try:
                    os.unlink(self._record_path(s))
                    dropped += 1
                except OSError:  # already gone
                    pass
        if dropped:
            _checkpoint._fsync_dir(self.path)
            obs.flightrec.record("journal.truncate", through=seq, dropped=dropped, path=self.path)
            _note_cursor(self.path, self.last_seq)
        return dropped

    def clear(self) -> int:
        """Drop every record (the snapshot file, if any, is left in place)."""
        return self.truncate_through(self._next_seq)


def replay(
    metric: Any,
    journal: Union[Journal, str, os.PathLike],
    after_seq: int = -1,
    through_seq: Optional[int] = None,
    skip_seqs: Optional[Collection[int]] = None,
) -> int:
    """Re-apply journaled batches through ``metric.update``; returns the batch count.

    ``through_seq`` (a post-mortem bundle's journal cursor) stops replay at that record, and ``skip_seqs``
    omits the given records (a serving controller's shed batches).
    """
    jr = journal if isinstance(journal, Journal) else Journal(journal)
    skips = frozenset(int(s) for s in skip_seqs) if skip_seqs else frozenset()
    n = 0
    skipped = 0
    for seq, args, kwargs in jr.read(after_seq=after_seq):
        if through_seq is not None and seq > through_seq:
            break
        if seq in skips:
            skipped += 1
            continue
        metric.update(*args, **kwargs)
        n += 1
    if skipped:
        obs.flightrec.record("journal.replay_skipped", skipped=skipped, path=jr.path)
    if n:
        obs.telemetry.counter("robust.journal_replays").inc(n)
        obs.telemetry.event("robust.journal_replay", cat="robust", args={"batches": n, "path": jr.path})
        obs.flightrec.record(
            "journal.replay", batches=n, path=jr.path,
            through=through_seq if through_seq is not None else jr.last_seq,
        )
    return n


def recover(
    metric: Any, path: Union[str, os.PathLike], cursor: Any = None,
    skip_seqs: Optional[Collection[int]] = None,
) -> Dict[str, Any]:
    """Restore ``snapshot + replay(journal)`` from a journal directory into ``metric``.

    The durable snapshot, if present, is restored first through the metric's own ``restore`` (so
    collections round-trip too), then every record past its high-water mark is replayed; ``cursor`` (a
    sequence number, a cursor dict or a bundle document) stops replay there. Returns
    ``{"snapshot_restored", "replayed", "after_seq", "through_seq"}``.
    """
    path = os.fspath(path)
    through = _cursor_seq(cursor)
    # recovery means the previous writer is gone: its lock is stale by definition
    break_lock(path)
    jr = Journal(path)
    snap_path = os.path.join(path, SNAPSHOT_FILENAME)
    restored = False
    after = -1
    if os.path.exists(snap_path):
        blob = _checkpoint.load_snapshot(snap_path)
        after = int(blob.pop("journal_seq", -1))
        metric.restore(blob)
        restored = True
    replayed = replay(metric, jr, after_seq=after, through_seq=through, skip_seqs=skip_seqs)
    return {"snapshot_restored": restored, "replayed": replayed, "after_seq": after, "through_seq": through}


class MetricJournal:
    """Write-ahead journaled proxy for one metric or collection: ``Metric.journal(...)``.

    Every ``update``/``forward`` appends the batch durably *before* applying it, and every ``every_k``
    appends a durable snapshot is taken and the journal truncated. Use as a context manager::

        with metric.journal("ckpt/m0", every_k=64) as jm:
            for batch in stream:
                jm.update(*batch)          # durable before applied
        # preempted? a fresh process resumes with the same bits:
        with fresh_metric.journal("ckpt/m0", resume=True) as jm:
            ...

    A clean exit takes a final snapshot; an error exit leaves the journal tail in place, so recovery still
    replays the whole stream. ``buffered(k)`` returns the target's
    :class:`~torchmetrics_tpu_torch.ops.dispatch.BufferedUpdater` with this journal at its write-ahead seam.
    """

    def __init__(
        self,
        metric: Any,
        path: Union[str, os.PathLike],
        every_k: int = 64,
        resume: bool = False,
        max_pending: int = 65536,
    ) -> None:
        if int(every_k) < 1:
            raise ValueError(f"journal(every_k) needs every_k >= 1, got {every_k}")
        self.metric = metric
        self._resume = bool(resume)
        self.recovered: Optional[Dict[str, Any]] = None
        if self._resume:
            # recover() first: it breaks the stale lock of the preempted writer before this proxy takes it
            self.recovered = recover(self.metric, os.fspath(path))
        self._lock = _WriterLock(os.fspath(path))
        os.makedirs(os.fspath(path), exist_ok=True)
        self._lock.acquire()
        self.journal = Journal(path, max_pending=max_pending)
        self._every_k = int(every_k)
        self._since_snapshot = 0

    @property
    def path(self) -> str:
        return self.journal.path

    def _append(self, args: tuple, kwargs: dict) -> None:
        self.journal.append(args, kwargs)
        self._since_snapshot += 1

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Journal the batch durably, apply it, snapshot and truncate on the ``every_k`` cycle."""
        self._append(args, kwargs)
        self.metric.update(*args, **kwargs)
        self._maybe_checkpoint()

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Journaled twin of ``metric.forward`` (the batch value returned as usual)."""
        self._append(args, kwargs)
        value = self.metric.forward(*args, **kwargs)
        self._maybe_checkpoint()
        return value

    __call__ = forward

    def compute(self, *args: Any, **kwargs: Any) -> Any:
        """A passthrough that journals nothing: a keyed metric's ``compute(keys=...)`` stays reachable."""
        return self.metric.compute(*args, **kwargs)

    def update_async(self, *args: Any, **kwargs: Any) -> Any:
        """Journaled twin of ``metric.update_async`` (JAX ``journal.py:496``).

        Wires this journal into the metric's ingestion engine, which appends the batch durably at ENQUEUE
        time, before it is even pending in the window, so a preemption mid-overlap recovers
        ``snapshot + replay`` bit-identically. The ``every_k`` snapshot cycle still runs; taking the snapshot
        quiesces the window (a quiesced snapshot is exact).
        """
        eng = self.metric.serve(journal=self.journal)
        if eng.journal is not self.journal:
            raise JournalError(
                "This metric's ingestion engine already journals to a different"
                " directory; one WAL per metric."
            )
        ticket = self.metric.update_async(*args, **kwargs)
        self._since_snapshot += 1
        self._maybe_checkpoint()
        return ticket

    def buffered(self, k: int) -> Any:
        """A :class:`BufferedUpdater` over the target with this journal at its seam."""
        return self.metric.buffered(k, journal=self.journal)

    @staticmethod
    def recover(metric: Any, path: Union[str, os.PathLike], cursor: Any = None) -> Dict[str, Any]:
        """``snapshot + replay(journal)`` into ``metric`` (the module-level :func:`recover`)."""
        return recover(metric, path, cursor=cursor)

    def close(self) -> None:
        """Release the exclusive writer lock (idempotent); the journal stays readable."""
        self._lock.release()

    def __del__(self) -> None:
        try:
            self._lock.release()
        except Exception:
            pass

    def _maybe_checkpoint(self) -> None:
        if self._since_snapshot >= self._every_k:
            self.checkpoint()

    def checkpoint(self) -> str:
        """Take a durable snapshot now and truncate the journal prefix it covers."""
        blob = self.metric.snapshot()
        blob["journal_seq"] = self.journal.last_seq
        out = _checkpoint.save_snapshot(blob, os.path.join(self.journal.path, SNAPSHOT_FILENAME))
        self.journal.truncate_through(self.journal.last_seq)
        self._since_snapshot = 0
        return out

    def __enter__(self) -> "MetricJournal":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        # clean exit: consolidate to a snapshot; error exit: leave the tail, which recovery replays. The
        # lock is released on both paths (the process is alive; a held lock would block its next proxy)
        try:
            if exc_type is None:
                self.checkpoint()
        finally:
            self.close()
        return False
