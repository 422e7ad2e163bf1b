"""Durable metric-state snapshots: versioned, CRC-checksummed host-side blobs (counterpart of
``torchmetrics_tpu/robust/checkpoint.py``).

``Metric.state_dict`` covers only the *persistent* states and carries no integrity information. A
snapshot is its full-fidelity, crash-consistent twin:

- **host-side numpy**: every tensor and list state is read to the host in one synchronised copy
  (the states packed byte for byte into one device buffer, then one transfer), so the blob never
  aliases a static buffer that a later graph replay writes in place;
- **structure**: the tensor/list split and each entry's dtype and shape, validated on restore
  against the receiving metric's registered states;
- **versioned and checksummed**: ``version`` gates format evolution, and ``crc`` (zlib.crc32 over a
  canonical serialisation of names, dtypes, shapes and raw bytes) rejects a torn or corrupted blob
  with a :class:`~torchmetrics_tpu_torch.utils.exceptions.SnapshotError`;
- **consistent against the dispatch tiers**: a snapshot while a graph step writes the state, or
  with batches pending in a buffered accumulator, raises; the blob records the ``state_generation``
  it was taken at.

The blob and the ``.tmsnap`` file are the JAX package's, byte for byte (``FORMAT``, ``VERSION``,
``SNAPSHOT_MAGIC``, :func:`_canonical_bytes`), so a snapshot that the JAX package writes restores
here. The port counts in int64 where JAX's states are int32 (ROADMAP.md, "Differences the port
keeps on purpose"): a blob's narrower JAX dtype is accepted where ``interop.load_numpy_state``
accepts it (int32, or whole float32 counts, into int64) and widened on restore; the CRC is over the
arrays as stored. Blobs are plain dicts of numpy arrays and ints: picklable and ``np.savez``-able.
"""
from __future__ import annotations

import os
import pickle
import struct
import tempfile
import zlib
from typing import Any, Dict, List, Sequence, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.utils.exceptions import ReconciliationError, SnapshotError

FORMAT = "tm-tpu-metric-snapshot"
COLLECTION_FORMAT = "tm-tpu-collection-snapshot"
RECONCILIATION_FORMAT = "tm-tpu-reconciliation"
VERSION = 1

#: on-disk container: magic + little-endian (crc32, payload length) + pickled blob
SNAPSHOT_MAGIC = b"TMSNAP1\n"
_DISK_HEADER = struct.Struct("<IQ")
#: the JAX package's narrower dtypes that a port state of the key's dtype takes on restore (int32 counts,
#: and float32 counts that must be whole, into int64), as ``interop.load_numpy_state`` takes them
_NARROWER = {torch.int64: ("int32", "float32")}
#: the most bytes one host copy of a snapshot moves; larger states go in several
SNAPSHOT_BLOCK_BYTES = 1 << 30


def _canonical_bytes(tensors: Dict[str, np.ndarray], lists: Dict[str, List[np.ndarray]]) -> bytes:
    """Deterministic byte serialisation of the state payload, the CRC input: names, kinds, dtypes,
    shapes and raw array bytes, so any bit flip in metadata or data changes the checksum."""
    chunks: List[bytes] = []
    for name in sorted(tensors):
        arr = tensors[name]
        chunks.append(f"T:{name}:{arr.dtype.str}:{arr.shape}".encode())
        chunks.append(np.ascontiguousarray(arr).tobytes())
    for name in sorted(lists):
        chunks.append(f"L:{name}:{len(lists[name])}".encode())
        for arr in lists[name]:
            chunks.append(f"E:{arr.dtype.str}:{arr.shape}".encode())
            chunks.append(np.ascontiguousarray(arr).tobytes())
    return b"\x00".join(chunks)


def _checksum(tensors: Dict[str, np.ndarray], lists: Dict[str, List[np.ndarray]]) -> int:
    return zlib.crc32(_canonical_bytes(tensors, lists)) & 0xFFFFFFFF


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def host_arrays(values: Sequence[Tensor]) -> List[np.ndarray]:
    """``values`` as host numpy arrays of their own, read in as few transfers as possible: the tensors of
    each device packed byte for byte into one buffer there (in blocks of at most
    :data:`SNAPSHOT_BLOCK_BYTES`), each buffer copied once, then split by dtype and shape."""
    out: List[Any] = [None] * len(values)
    by_device: Dict[torch.device, List[int]] = {}
    for i, v in enumerate(values):
        by_device.setdefault(v.device, []).append(i)
    for idx in by_device.values():
        blocks: List[List[int]] = [[]]
        size = 0
        for i in idx:
            n = values[i].numel() * values[i].element_size()
            if blocks[-1] and size + n > SNAPSHOT_BLOCK_BYTES:
                blocks.append([])
                size = 0
            blocks[-1].append(i)
            size += n
        for block in blocks:
            raw = torch.cat([values[i].detach().reshape(-1).contiguous().view(torch.uint8) for i in block]).cpu().numpy()
            offset = 0
            for i in block:
                v = values[i]
                n = v.numel() * v.element_size()
                out[i] = raw[offset:offset + n].view(_numpy_dtype(v.dtype)).reshape(tuple(v.shape)).copy()
                offset += n
    return out


def snapshot_metric(metric: Any) -> Dict[str, Any]:
    """A durable host-side snapshot blob of ``metric``'s full state.

    Raises :class:`SnapshotError` when the state is not readable at a consistent point: batches pending
    in a buffered accumulator (flush or discard them first: a snapshot must never hold half a window),
    or a graph step writing the state buffers in place. A served metric's ingestion window is quiesced first
    (JAX ``checkpoint.py:80``): a quiesced snapshot is exact over every enqueued batch.
    """
    serve_engine = metric.__dict__.get("_serve")
    if serve_engine is not None:
        serve_engine.quiesce()
    pending = metric.__dict__.get("_buffered_pending", 0)
    if pending:
        raise SnapshotError(
            f"Cannot snapshot {type(metric).__name__}: {pending} batch(es) are pending in a"
            " buffered accumulator, so the state is stale mid-window. Call flush() on the"
            " buffer (or let its context manager exit) before snapshotting."
        )
    state = metric._state
    if state.inflight:
        raise SnapshotError(
            f"Cannot snapshot {type(metric).__name__} mid-flight: a graph step is writing the state"
            " buffers in place. Snapshot from the training loop, not from callbacks that run inside a"
            " forward step."
        )
    names = list(state.tensors)
    list_names = list(state.lists)
    flat = [state.tensors[n] for n in names] + [e for n in list_names for e in state.lists[n]]
    arrays = host_arrays(flat)
    tensors = dict(zip(names, arrays[: len(names)]))
    lists: Dict[str, List[np.ndarray]] = {}
    pos = len(names)
    for n in list_names:
        k = len(state.lists[n])
        lists[n] = arrays[pos:pos + k]
        pos += k
    obs.telemetry.counter("robust.snapshots").inc()
    blob = {
        "format": FORMAT,
        "version": VERSION,
        "class": type(metric).__name__,
        "tensors": tensors,
        "lists": lists,
        "update_count": int(metric._update_count),
        "update_called": bool(metric._update_called),
        "state_generation": int(state.generation),
        "crc": _checksum(tensors, lists),
    }
    keys = _keyed_descriptor(metric)
    if keys is not None:
        blob["keys"] = keys
    window = _window_descriptor(metric)
    if window is not None:
        blob["window"] = window
    sketch = _sketch_descriptor(metric)
    if sketch is not None:
        blob["sketch"] = sketch
    # JAX adds a "sharding" descriptor for a sharded metric (``Metric.shard``); no port metric is sharded
    # yet (ROADMAP.md, queue A, item 9). A JAX blob that carries one restores as JAX restores it into an
    # unsharded metric: the payload is the gathered full state, and the descriptor is informational.
    return blob


def _sketch_descriptor(metric: Any) -> Any:
    """Per-state sketch descriptors (kind, parameters, error bound) of a sketch-backed metric, else None.
    Validated on restore before the shapes: two sketches of different kind or capacity can have the same
    array shapes but are not the same state."""
    specs = metric.__dict__.get("_sketch_specs")
    if not specs:
        return None
    return {name: spec.describe() for name, spec in specs.items()}


def _keyed_descriptor(metric: Any) -> Any:
    """The tenant-axis descriptor of a keyed metric (key count, template class, routing strategy), else
    None: a blob never restores into a keyed metric of another key space."""
    num_keys = getattr(metric, "num_keys", None)
    template = getattr(metric, "template", None)
    if num_keys is None or template is None:
        return None
    return {
        "num_keys": int(num_keys),
        "template": type(template).__name__,
        "strategy": getattr(metric, "strategy", None),
    }


def _window_descriptor(metric: Any) -> Any:
    """The online-window descriptor (geometry, advance cadence or decay, template class), else None.
    Validated before the shapes: a ring of the same shapes but another ``advance_every`` is another state."""
    desc = getattr(metric, "online_descriptor", None)
    if desc is None:
        return None
    return dict(desc)


def _dtype_accepted(arr_dtype: np.dtype, cur: Tensor) -> bool:
    """The blob's dtype is the state's, or the JAX package's narrower dtype of it (:data:`_NARROWER`)."""
    if np.dtype(arr_dtype) == _numpy_dtype(cur.dtype):
        return True
    return np.dtype(arr_dtype).name in _NARROWER.get(cur.dtype, ())


def _validate_blob(metric: Any, blob: Any) -> None:
    if not isinstance(blob, dict) or blob.get("format") not in (FORMAT,):
        raise SnapshotError(
            f"Not a metric snapshot blob: expected format {FORMAT!r},"
            f" got {blob.get('format') if isinstance(blob, dict) else type(blob).__name__!r}"
        )
    if blob.get("version") != VERSION:
        raise SnapshotError(
            f"Snapshot version mismatch: blob is v{blob.get('version')!r}, this build reads"
            f" v{VERSION}. Re-snapshot with the current build (format evolution is gated on"
            " this field precisely so stale blobs fail loudly)."
        )
    if blob.get("class") != type(metric).__name__:
        raise SnapshotError(
            f"Snapshot was taken from {blob.get('class')!r} but is being restored into"
            f" {type(metric).__name__!r}"
        )
    tensors, lists = blob.get("tensors"), blob.get("lists")
    if not isinstance(tensors, dict) or not isinstance(lists, dict):
        raise SnapshotError("Snapshot blob is missing its tensors/lists payload")
    crc = _checksum(
        {k: np.asarray(v) for k, v in tensors.items()},
        {k: [np.asarray(e) for e in v] for k, v in lists.items()},
    )
    if crc != blob.get("crc"):
        raise SnapshotError(
            f"Snapshot checksum mismatch (stored {blob.get('crc')!r}, computed {crc}):"
            " the blob was corrupted or truncated in storage. Refusing to restore."
        )
    state = metric._state
    if set(tensors) != set(state.tensors) or set(lists) != set(state.lists):
        raise SnapshotError(
            f"Snapshot state names do not match {type(metric).__name__}'s registered states:"
            f" blob has tensors={sorted(tensors)} lists={sorted(lists)}, metric has"
            f" tensors={sorted(state.tensors)} lists={sorted(state.lists)}"
        )
    expected_keys = _keyed_descriptor(metric)
    if expected_keys is not None:
        keys = blob.get("keys")
        if not isinstance(keys, dict):
            raise SnapshotError(
                f"Snapshot has no tenant-axis descriptor but {type(metric).__name__}"
                f" expects {expected_keys['num_keys']} keys — the blob was taken from an"
                " unkeyed metric."
            )
        if int(keys.get("num_keys", -1)) != expected_keys["num_keys"]:
            raise SnapshotError(
                f"Snapshot holds {keys.get('num_keys')!r} key streams, metric holds"
                f" {expected_keys['num_keys']} — refusing to restore across key spaces."
            )
        if keys.get("template") != expected_keys["template"]:
            raise SnapshotError(
                f"Snapshot keys were accumulated by template {keys.get('template')!r},"
                f" metric's template is {expected_keys['template']!r}"
            )
    expected_window = _window_descriptor(metric)
    if expected_window is not None:
        window = blob.get("window")
        if not isinstance(window, dict):
            raise SnapshotError(
                f"Snapshot has no window descriptor but {type(metric).__name__} is an"
                f" online-window metric ({expected_window['mode']}) — the blob was"
                " taken from a plain (or pre-window) metric."
            )
        if window != expected_window:
            raise SnapshotError(
                f"Snapshot window descriptor {window!r} does not match the metric's"
                f" {expected_window!r} — rings of different geometry, advance cadence,"
                " or decay are not the same state; refusing to restore."
            )
    expected_sketch = _sketch_descriptor(metric)
    if expected_sketch is not None:
        sketch = blob.get("sketch")
        if not isinstance(sketch, dict):
            raise SnapshotError(
                f"Snapshot has no sketch descriptor but {type(metric).__name__} registers"
                f" sketch state(s) {sorted(expected_sketch)} — the blob was taken from a"
                " non-sketch (or pre-sketch) metric."
            )
        for name, want in expected_sketch.items():
            got = sketch.get(name)
            if got != want:
                raise SnapshotError(
                    f"Snapshot sketch state {name!r} was accumulated as {got!r}, metric"
                    f" expects {want!r} — sketches of different kind/capacity/error"
                    " contract are not mergeable states; refusing to restore."
                )
    for name, arr in tensors.items():
        cur = state.tensors[name]
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(cur.shape) or not _dtype_accepted(arr.dtype, cur):
            raise SnapshotError(
                f"Snapshot state {name!r} has shape/dtype {arr.shape}/{arr.dtype}, metric"
                f" expects {tuple(cur.shape)}/{_numpy_dtype(cur.dtype)}"
            )


def restore_metric(metric: Any, blob: Dict[str, Any]) -> None:
    """Restore ``metric`` from a :func:`snapshot_metric` blob, after full validation.

    Installs fresh device tensors in the registered dtypes (never aliasing the blob; a narrower JAX
    dtype is widened, float counts checked whole), which the next graph step copies into its static
    buffers; resets the sync and compute caches, and restores the update count, so that ``mean``
    merges and the no-update warning stay right. Bit-identical round trip on either dispatch tier.
    """
    _validate_blob(metric, blob)
    state = metric._state
    for name, arr in blob["tensors"].items():
        state.tensors[name] = metric._as_state(name, np.asarray(arr))
    for name, entries in blob["lists"].items():
        state.lists[name] = [metric._as_state(name, np.asarray(e)) for e in entries]
    state.inflight = False
    metric._update_count = int(blob["update_count"])
    metric._update_called = bool(blob["update_called"])
    metric._computed = None
    metric._cache = None
    metric._is_synced = False
    obs.telemetry.counter("robust.restores").inc()


def snapshot_collection(collection: Any) -> Dict[str, Any]:
    """Snapshot every member of a ``MetricCollection`` under its registration name."""
    blobs = {name: snapshot_metric(m) for name, m in collection.items(keep_base=True, copy_state=False)}
    return {"format": COLLECTION_FORMAT, "version": VERSION, "metrics": blobs}


def restore_collection(collection: Any, blob: Any) -> None:
    """Restore a collection from :func:`snapshot_collection`; members must match by name. The members of a
    compute group then hold the restored leader's tensors again."""
    if not isinstance(blob, dict) or blob.get("format") != COLLECTION_FORMAT:
        raise SnapshotError(
            f"Not a collection snapshot blob: expected format {COLLECTION_FORMAT!r},"
            f" got {blob.get('format') if isinstance(blob, dict) else type(blob).__name__!r}"
        )
    if blob.get("version") != VERSION:
        raise SnapshotError(
            f"Collection snapshot version mismatch: blob is v{blob.get('version')!r},"
            f" this build reads v{VERSION}"
        )
    members = dict(collection.items(keep_base=True, copy_state=False))
    blobs = blob.get("metrics")
    if not isinstance(blobs, dict) or set(blobs) != set(members):
        got = sorted(blobs) if isinstance(blobs, dict) else blobs
        raise SnapshotError(
            f"Collection snapshot members {got} do not match collection members"
            f" {sorted(members)}"
        )
    for name, m in members.items():
        restore_metric(m, blobs[name])
    if collection._enable_compute_groups and collection._groups_checked:
        collection._compute_groups_create_state_ref()


# ---------------------------------------------------------------------------
# Durable disk persistence (atomic temp-file + os.replace + fsync)
# ---------------------------------------------------------------------------

def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed file survives power loss (best effort)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # a platform without directory open: the rename still landed
        return
    try:
        os.fsync(fd)
    except OSError:  # some filesystems reject a directory fsync
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: Union[str, os.PathLike], data: bytes) -> str:
    """Crash-consistent byte write: temp file in the target directory, fsync, ``os.replace``, fsync of the
    directory. The target holds either its previous content or the complete new content, never a torn
    one. Shared by snapshot persistence and the update journal."""
    path = os.fspath(path)
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tm-tmp-")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(directory)
    return path


def save_snapshot(blob: Dict[str, Any], path: Union[str, os.PathLike]) -> str:
    """Durably persist a :func:`snapshot_metric` / :func:`snapshot_collection` blob to disk.

    The file is written atomically (temp file + ``os.replace`` + fsync of file and directory), so a
    preemption mid-write leaves the previous snapshot or the new one, never garbage. The container adds an
    outer CRC over the pickled payload on top of the blob's own state CRC; :func:`load_snapshot` checks both.
    """
    if not isinstance(blob, dict) or blob.get("format") not in (FORMAT, COLLECTION_FORMAT):
        raise SnapshotError(
            "save_snapshot expects a snapshot blob from Metric.snapshot() /"
            f" MetricCollection.snapshot(); got format"
            f" {blob.get('format') if isinstance(blob, dict) else type(blob).__name__!r}"
        )
    payload = pickle.dumps(blob, protocol=pickle.HIGHEST_PROTOCOL)
    header = SNAPSHOT_MAGIC + _DISK_HEADER.pack(zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    out = atomic_write_bytes(path, header + payload)
    obs.telemetry.counter("robust.snapshot_saves").inc()
    return out


def load_snapshot(path: Union[str, os.PathLike]) -> Dict[str, Any]:
    """Read a :func:`save_snapshot` file back to a blob, validating the disk container.

    Rejects missing, truncated or corrupted files with :class:`SnapshotError`; the blob's own state CRC is
    checked again when the blob is restored into a metric.
    """
    path = os.fspath(path)
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except OSError as err:
        raise SnapshotError(f"Cannot read snapshot file {path!r}: {err}") from err
    header_len = len(SNAPSHOT_MAGIC) + _DISK_HEADER.size
    if len(raw) < header_len or not raw.startswith(SNAPSHOT_MAGIC):
        raise SnapshotError(
            f"{path!r} is not a torchmetrics-tpu snapshot file (bad magic/truncated header)"
        )
    crc, length = _DISK_HEADER.unpack(raw[len(SNAPSHOT_MAGIC):header_len])
    payload = raw[header_len:]
    if len(payload) != length:
        raise SnapshotError(
            f"Snapshot file {path!r} is truncated: header promises {length} payload bytes,"
            f" file holds {len(payload)}. Refusing to restore."
        )
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise SnapshotError(
            f"Snapshot file {path!r} failed its container checksum: the file was corrupted"
            " in storage. Refusing to restore."
        )
    blob = pickle.loads(payload)
    if not isinstance(blob, dict) or blob.get("format") not in (FORMAT, COLLECTION_FORMAT):
        raise SnapshotError(f"Snapshot file {path!r} does not contain a snapshot blob")
    return blob


# ---------------------------------------------------------------------------
# Rank re-admission: state reconciliation handshake
# ---------------------------------------------------------------------------

def reconciliation_offer(metric: Any, responding_ranks: Sequence[int] = (), epoch: int = 0) -> Dict[str, Any]:
    """The re-admission handshake blob that the quorum side sends a rejoining rank: a full snapshot of
    ``metric``'s current state (take it inside ``sync_context`` to ship the merged view), the ranks that view
    covers, a caller-defined epoch and the consistency grade it was taken at."""
    blob = snapshot_metric(metric)
    return {
        "format": RECONCILIATION_FORMAT,
        "version": VERSION,
        "snapshot": blob,
        "responding_ranks": tuple(int(r) for r in responding_ranks),
        "epoch": int(epoch),
        "consistency": str(getattr(metric, "world_consistent", "full")),
    }


def accept_reconciliation(metric: Any, offer: Any, mode: str = "adopt") -> Dict[str, Any]:
    """Apply a re-admission handshake offer on the rejoining rank.

    ``mode="adopt"`` (a cold rejoin: the rank's local state is gone) restores the offered snapshot into
    ``metric``. ``mode="verify"`` (a warm rejoin: the rank recovered its own state by snapshot and journal
    replay) checks that the offer fits the metric (class, state names, shapes, CRC) without overwriting the
    recovered state. Both raise :class:`ReconciliationError` on an invalid offer and return the offer's
    metadata (``responding_ranks``, ``epoch``, ``consistency``, ``mode``).
    """
    if not isinstance(offer, dict) or offer.get("format") != RECONCILIATION_FORMAT:
        raise ReconciliationError(
            f"Not a reconciliation offer: expected format {RECONCILIATION_FORMAT!r}, got"
            f" {offer.get('format') if isinstance(offer, dict) else type(offer).__name__!r}"
        )
    if offer.get("version") != VERSION:
        raise ReconciliationError(
            f"Reconciliation version mismatch: offer is v{offer.get('version')!r}, this"
            f" build speaks v{VERSION}"
        )
    snapshot = offer.get("snapshot")
    try:
        if mode == "adopt":
            restore_metric(metric, snapshot)
        elif mode == "verify":
            _validate_blob(metric, snapshot)
        else:
            raise ValueError(f"accept_reconciliation mode must be 'adopt' or 'verify', got {mode!r}")
    except SnapshotError as err:
        raise ReconciliationError(f"Reconciliation offer rejected: {err}") from err
    obs.telemetry.counter("robust.reconciliations").inc()
    obs.telemetry.event(
        "robust.reconciliation", cat="robust",
        args={"mode": mode, "epoch": offer.get("epoch"), "responding_ranks": list(offer.get("responding_ranks", ()))},
    )
    return {
        "responding_ranks": tuple(offer.get("responding_ranks", ())),
        "epoch": offer.get("epoch", 0),
        "consistency": offer.get("consistency", "full"),
        "mode": mode,
    }
