"""Crash-consistent post-mortem bundles: the flight recorder's durable landing zone (counterpart of
``torchmetrics_tpu/obs/bundle.py``).

A **bundle** is one atomically written, versioned, per-section-CRC'd file capturing what a post-mortem
needs at the instant a failure seam fired: the flight ring (:mod:`torchmetrics_tpu_torch.obs.flightrec`),
the full counter/gauge/series snapshot, a recent Perfetto trace slice (the telemetry log and the serve
trace ring), the metric's last sync summary, the write-ahead journal cursor (so
:func:`torchmetrics_tpu_torch.robust.journal.recover` can replay **bit-identically** to the captured
instant), and an environment fingerprint.

:func:`capture_bundle` fires from the port's failure seams: the serving tier's drain death, apply
failure and abandonment, a corrupt journal record, ``nan_policy="raise"``, the chaos injectors, and the
explicit ``Metric.dump_diagnostics()``. Capture is **best-effort by contract**: a failure path must never
become a second failure, so any capture-time error degrades to a counted warning
(``flight.bundle_capture_failures``) instead of raising.

Disk container (``.tmb``): the JAX package's byte for byte, ``TMBDL1\\n`` magic + little-endian
``(crc32, length)`` over a pickled document whose ``sections`` map holds each section as its OWN pickled
byte blob with its OWN crc32, so a torn or bit-flipped section is named precisely. Sections hold plain
Python objects, never tensors, so each package reads the other's bundles. Writes go through
:func:`~torchmetrics_tpu_torch.robust.checkpoint.atomic_write_bytes` (temp file + ``os.replace`` + fsync of
file and directory): a preemption mid-capture leaves either no bundle or a complete one.

Sections whose source is not ported yet take the empty forms the JAX package writes when their source
fails: ``memory`` (the device-memory ledger) and
``xplane`` (the compile plane). The ``env`` section records torch's and CUDA's versions, the device name
and count where the JAX package records JAX's.

CLI::

    python -m torchmetrics_tpu_torch.obs.bundle inspect  <bundle.tmb>
    python -m torchmetrics_tpu_torch.obs.bundle validate <bundle.tmb> [...]   # exit 0/1
    python -m torchmetrics_tpu_torch.obs.bundle diff     <a.tmb> <b.tmb>
    python -m torchmetrics_tpu_torch.obs.bundle merge-fleet <bundles or dirs> [--incident ID] [--output P]

The rank-zero **merged view** (``capture_bundle(..., merged=True)``) gathers every rank's core payload
(flight ring, counters) over an injectable ``gather_fn``, or ``gather_all_arrays`` of a ``uint8`` tensor in
an initialised ``torch.distributed`` world above 1, into a ``ranks`` section of one rank-zero bundle.

Env knobs: ``TM_TPU_BUNDLE_DIR`` (capture directory; default ``<tmp>/tm-tpu-bundles``),
``TM_TPU_BUNDLES=0`` (master off switch), ``TM_TPU_BUNDLE_KEEP`` (retained bundles per directory,
default 64).
"""
from __future__ import annotations

import itertools
import json
import os
import pickle
import struct
import sys
import tempfile
import zlib
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

from torchmetrics_tpu_torch.obs import flightrec
from torchmetrics_tpu_torch.obs.telemetry import telemetry
from torchmetrics_tpu_torch.utils.exceptions import BundleError
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = [
    "FORMAT", "VERSION", "REQUIRED_SECTIONS", "BundleError",
    "build_bundle", "capture_bundle", "load_bundle", "validate_bundle",
    "inspect_bundle", "diff_bundles", "merge_fleet_bundles", "last_bundle_path",
    "capture_dir", "main",
]

FORMAT = "tm-tpu-flight-bundle"
VERSION = 1
SUFFIX = ".tmb"
BUNDLE_MAGIC = b"TMBDL1\n"
_DISK_HEADER = struct.Struct("<IQ")

ENV_BUNDLE_DIR = "TM_TPU_BUNDLE_DIR"
ENV_BUNDLES = "TM_TPU_BUNDLES"
ENV_BUNDLE_KEEP = "TM_TPU_BUNDLE_KEEP"

#: sections every bundle must carry (``validate`` enforces presence + per-section CRC)
REQUIRED_SECTIONS = (
    "flight", "telemetry", "trace", "health", "sync", "journal", "memory", "env",
    "xplane",
)

#: recent Perfetto events retained per source ring (telemetry log + serve-trace ring)
_TRACE_SLICE = 512

_capture_seq = itertools.count(1).__next__
_last_path: Optional[str] = None
_dir_override: Optional[str] = None


def _enabled() -> bool:
    return str(os.environ.get(ENV_BUNDLES, "1")).strip().lower() not in ("0", "false", "no", "off")


def _default_dir() -> str:
    if _dir_override is not None:
        return _dir_override
    return os.environ.get(ENV_BUNDLE_DIR) or os.path.join(tempfile.gettempdir(), "tm-tpu-bundles")


@contextmanager
def capture_dir(path: Union[str, os.PathLike]) -> Iterator[str]:
    """Scope every auto-capture inside the block to ``path`` (chaos cells, tests)."""
    global _dir_override
    prev = _dir_override
    _dir_override = os.fspath(path)
    try:
        yield _dir_override
    finally:
        _dir_override = prev


def last_bundle_path() -> Optional[str]:
    """Path of the most recently captured bundle in this process (None before any)."""
    return _last_path


def _world() -> int:
    """The ``torch.distributed`` world size (1 when no process group is initialised)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_world_size())
    except Exception:
        pass
    return 1


def _rank() -> int:
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:
        pass
    return 0


def _plain(obj: Any) -> Any:
    """``obj`` with every tensor and numpy value turned into plain Python (lists, numbers, strings), so
    that a bundle unpickles without torch, as the JAX package's reader needs."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_plain(v) for v in obj]
        return out if isinstance(obj, list) else tuple(out)
    if isinstance(obj, (str, bytes, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "tolist") and hasattr(obj, "dtype"):  # a tensor, a numpy array or scalar
        try:
            return obj.detach().cpu().tolist() if hasattr(obj, "detach") else obj.tolist()
        except Exception:
            return repr(obj)
    return obj


# ------------------------------------------------------------------ section builders
def _env_section() -> Dict[str, Any]:
    """Environment/config fingerprint: enough to answer "what build, what knobs"."""
    out: Dict[str, Any] = {"python": sys.version.split()[0]}
    try:
        import torchmetrics_tpu_torch

        out["package_version"] = torchmetrics_tpu_torch.__version__
    except Exception:
        out["package_version"] = None
    try:
        import torch

        # the JAX package records jax_version here; backend and device_count keep its names
        out["torch_version"] = torch.__version__
        out["cuda_version"] = torch.version.cuda
        cuda = torch.cuda.is_available()
        out["backend"] = "cuda" if cuda else "cpu"
        out["device_count"] = torch.cuda.device_count() if cuda else 0
        out["device_name"] = torch.cuda.get_device_name(0) if cuda else None
    except Exception:
        out["torch_version"] = out["cuda_version"] = out["backend"] = out["device_name"] = None
        out["device_count"] = 0
    out["env"] = {
        k: v for k, v in sorted(os.environ.items())
        if k.startswith(("TM_TPU_", "TORCH_", "CUDA_VISIBLE_DEVICES"))
    }
    # the stable identity (host, pid, rank, start time): distinguishes "rank 3" from "rank 3 after a
    # restart" when fleet bundles merge
    try:
        from torchmetrics_tpu_torch.obs.telemetry import process_fingerprint

        out["process"] = process_fingerprint()
    except Exception:  # pragma: no cover - the section must build regardless
        out["process"] = None
    return out


def _health_section() -> Dict[str, Any]:
    """The bounded sync's rank-health ledger, skew report and gather statistics (JAX ``bundle.py:161``)."""
    try:
        from torchmetrics_tpu_torch.parallel import sync as _sync

        return {
            "ranks": {int(r): dict(h) for r, h in _sync.health_ledger().report().items()},
            "skew": _sync.last_skew_report(),
            "gather_stats": _sync.local_gather_stats(),
        }
    except Exception:
        return {"ranks": {}, "skew": None, "gather_stats": None}


def _journal_section(metric: Optional[Any]) -> Dict[str, Any]:
    """The write-ahead journal cursor: where replay must stop to match this capture."""
    cursor: Optional[Dict[str, Any]] = None
    if metric is not None:
        eng = getattr(metric, "__dict__", {}).get("_serve")
        jr = getattr(eng, "journal", None) if eng is not None else None
        if jr is not None:
            cursor = {
                "path": jr.path,
                "last_seq": jr.last_seq,
                "snapshot_present": os.path.exists(
                    os.path.join(jr.path, "snapshot.tmsnap")
                ),
            }
    if cursor is None:
        try:
            from torchmetrics_tpu_torch.robust import journal as _journal

            cursor = _journal.last_cursor()
        except Exception:
            cursor = None
    return {"cursor": cursor}


def _memory_section() -> Dict[str, Any]:
    """The device-memory ledger (``obs/memory``) is not ported yet: the JAX package's empty form."""
    return {"rows": [], "totals": {}}


def _xplane_section() -> Dict[str, Any]:
    """The compile plane (``obs/xplane``) is not ported yet: the JAX package's empty form."""
    return {"version": 1, "compiles": [], "seam_matrix": {"seams": [], "metrics": [], "count": 0},
            "counters": {}}


def _metric_section(metric: Any) -> Dict[str, Any]:
    """Per-metric context (shapes/dtypes/bytes, never payloads — bundles stay small)."""
    states: Dict[str, Any] = {}
    try:
        store = metric._state
        for name, arr in store.tensors.items():
            shape = tuple(int(d) for d in getattr(arr, "shape", ()))
            dtype = str(getattr(arr, "dtype", "")).replace("torch.", "")
            states[name] = {"shape": shape, "dtype": dtype}
        for name, entries in store.lists.items():
            states[name] = {"entries": len(entries)}
    except Exception:
        pass
    return {
        "class": type(metric).__name__,
        "update_count": int(getattr(metric, "_update_count", 0) or 0),
        "state_generation": int(getattr(metric, "state_generation", 0) or 0),
        "world_consistent": str(getattr(metric, "world_consistent", "full")),
        "nan_policy": str(getattr(metric, "nan_policy", "propagate")),
        "states": states,
    }


def _core_payload() -> Dict[str, Any]:
    """The per-rank slice the merged view gathers (JSON-serialisable, compact)."""
    snap = telemetry.snapshot()
    mem = _memory_section()
    return {
        "rank": _rank(),
        "flight": flightrec.snapshot(),
        "counters": snap["counters"],
        "gauges": snap["gauges"],
        "memory_totals": mem["totals"],
    }


def _gather_ranks(gather_fn: Optional[Callable]) -> List[Dict[str, Any]]:
    """Per-rank core payloads over the sync gather seam (world-1 = local only)."""
    payload = json.dumps(_core_payload())
    if gather_fn is not None:
        return [json.loads(p) for p in gather_fn(payload)]
    if _world() <= 1:
        return [_core_payload()]
    import numpy as np
    import torch

    from torchmetrics_tpu_torch.parallel.sync import gather_all_arrays

    buf = torch.from_numpy(np.frombuffer(payload.encode("utf-8"), np.uint8).copy())
    return [
        json.loads(bytes(g.cpu().numpy()).decode("utf-8")) for g in gather_all_arrays(buf)
    ]


def build_bundle(
    reason: str,
    metric: Optional[Any] = None,
    merged: bool = False,
    gather_fn: Optional[Callable] = None,
) -> Dict[str, Any]:
    """Assemble the in-memory bundle document (sections as live Python objects)."""
    import time

    events = telemetry.events()
    try:
        from torchmetrics_tpu_torch.obs import trace as _trace

        serve_events = _trace.events()
    except Exception:
        serve_events = []
    sections: Dict[str, Any] = {
        "flight": flightrec.snapshot(),
        "telemetry": telemetry.snapshot(),
        "trace": {
            "events": events[-_TRACE_SLICE:] + serve_events[-_TRACE_SLICE:],
            "telemetry_events_total": len(events),
            "serve_events_total": len(serve_events),
        },
        "health": _health_section(),
        "sync": dict(getattr(metric, "__dict__", {}).get("_tm_last_sync") or {}) or None,
        "journal": _journal_section(metric),
        "memory": _memory_section(),
        "env": _env_section(),
        "xplane": _xplane_section(),
    }
    if metric is not None:
        sections["metric"] = _metric_section(metric)
    if merged:
        sections["ranks"] = _gather_ranks(gather_fn)
    sections = _plain(sections)
    return {
        "format": FORMAT,
        "version": VERSION,
        "reason": str(reason),
        "rank": _rank(),
        "pid": os.getpid(),
        # the open incident (if any seam fired inside the dedup window): the key
        # `merge-fleet` groups per-rank bundles on
        "incident_id": flightrec.current_incident(),
        # wall-clock stamp is for HUMANS correlating bundles with external logs; no
        # metric value or replay boundary ever derives from it
        "captured_unix": time.time(),
        "captured_monotonic_us": telemetry.now_us(),
        "flight_last_seq": flightrec.last_seq(),
        "sections": sections,
    }


# ------------------------------------------------------------------ encode / decode
def encode(doc: Dict[str, Any]) -> bytes:
    """Bundle document → the on-disk container bytes (per-section CRC + outer CRC)."""
    packed_sections: Dict[str, Dict[str, Any]] = {}
    for name, obj in doc["sections"].items():
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        packed_sections[name] = {"crc": zlib.crc32(data) & 0xFFFFFFFF, "data": data}
    payload = pickle.dumps(
        {**{k: v for k, v in doc.items() if k != "sections"}, "sections": packed_sections},
        protocol=pickle.HIGHEST_PROTOCOL,
    )
    return BUNDLE_MAGIC + _DISK_HEADER.pack(zlib.crc32(payload) & 0xFFFFFFFF, len(payload)) + payload


def _decode_container(raw: bytes, origin: str) -> Dict[str, Any]:
    header_len = len(BUNDLE_MAGIC) + _DISK_HEADER.size
    if len(raw) < header_len or not raw.startswith(BUNDLE_MAGIC):
        raise BundleError(f"{origin}: not a flight bundle (bad magic/truncated header)")
    crc, length = _DISK_HEADER.unpack(raw[len(BUNDLE_MAGIC):header_len])
    payload = raw[header_len:]
    if len(payload) != length:
        raise BundleError(
            f"{origin}: truncated container (header promises {length} bytes,"
            f" file holds {len(payload)})"
        )
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise BundleError(f"{origin}: container checksum mismatch (corrupted in storage)")
    doc = pickle.loads(payload)
    if not isinstance(doc, dict) or doc.get("format") != FORMAT:
        raise BundleError(f"{origin}: payload is not a {FORMAT} document")
    if int(doc.get("version", 0)) > VERSION:
        raise BundleError(
            f"{origin}: bundle version {doc.get('version')} is newer than this reader"
            f" (supports <= {VERSION})"
        )
    return doc


def load_bundle(path: Union[str, os.PathLike], strict: bool = True) -> Dict[str, Any]:
    """Read a bundle file back to a document with live section objects.

    ``strict=True`` (default) additionally enforces every per-section CRC and the
    required-section set — the ``validate`` CLI path. ``strict=False`` decodes what it
    can, attaching ``_section_errors`` instead of raising (the ``inspect`` path: a
    damaged bundle should still render its readable sections).
    """
    path = os.fspath(path)
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except OSError as err:
        raise BundleError(f"Cannot read bundle {path!r}: {err}") from err
    doc = _decode_container(raw, path)
    sections: Dict[str, Any] = {}
    errors: Dict[str, str] = {}
    for name, packed in (doc.get("sections") or {}).items():
        data = packed.get("data")
        if not isinstance(data, bytes):
            errors[name] = "section payload missing"
            continue
        if zlib.crc32(data) & 0xFFFFFFFF != packed.get("crc"):
            errors[name] = "section checksum mismatch"
            continue
        try:
            sections[name] = pickle.loads(data)
        except Exception as err:
            errors[name] = f"section unpickle failed: {err!r}"
    missing = [s for s in REQUIRED_SECTIONS if s not in sections and s not in errors]
    if strict:
        if errors:
            raise BundleError(f"{path}: corrupt section(s) {sorted(errors)}: {errors}")
        if missing:
            raise BundleError(f"{path}: missing required section(s) {missing}")
    doc["sections"] = sections
    if errors or missing:
        doc["_section_errors"] = {**errors, **{m: "missing" for m in missing}}
    return doc


def validate_bundle(path: Union[str, os.PathLike]) -> Dict[str, Any]:
    """Strictly validate one bundle file; returns its summary dict or raises
    :class:`BundleError` naming the precise violation (container, section, or schema)."""
    doc = load_bundle(path, strict=True)
    flight = doc["sections"]["flight"]
    if not isinstance(flight.get("events"), list):
        raise BundleError(f"{path}: flight section carries no event list")
    for evt in flight["events"]:
        if not isinstance(evt, dict) or "seq" not in evt or "kind" not in evt:
            raise BundleError(f"{path}: malformed flight event {evt!r}")
    seqs = [e["seq"] for e in flight["events"]]
    if seqs != sorted(seqs):
        raise BundleError(f"{path}: flight ring sequence numbers are not monotonic")
    fleet = doc["sections"].get("fleet")
    if fleet is not None:
        # cross-rank seqs are NOT globally monotonic, so the fleet timeline lives in
        # its own section with its own ordering contract: sorted by (peer, seq)
        timeline = fleet.get("timeline")
        if not isinstance(timeline, list):
            raise BundleError(f"{path}: fleet section carries no timeline list")
        keys = []
        for evt in timeline:
            if not isinstance(evt, dict) or "peer" not in evt or "seq" not in evt:
                raise BundleError(f"{path}: malformed fleet timeline event {evt!r}")
            keys.append((evt["peer"], evt["seq"]))
        if keys != sorted(keys):
            raise BundleError(f"{path}: fleet timeline is not ordered by (peer, seq)")
        if not fleet.get("bundles"):
            raise BundleError(f"{path}: fleet section names no source bundles")
    # compile plane: ledger rows must be attributable (seq/metric/kernel/tier) and the
    # seam matrix must carry the full seam axis per row
    xplane = doc["sections"]["xplane"]
    if not isinstance(xplane, dict) or not isinstance(xplane.get("compiles"), list):
        raise BundleError(f"{path}: xplane section carries no compile-record list")
    for rec in xplane["compiles"]:
        if not isinstance(rec, dict) or not all(
            k in rec for k in ("seq", "metric", "kernel", "tier", "signature")
        ):
            raise BundleError(f"{path}: malformed xplane compile record {rec!r}")
    xseqs = [r["seq"] for r in xplane["compiles"]]
    if xseqs != sorted(xseqs):
        raise BundleError(f"{path}: xplane compile sequence numbers are not monotonic")
    matrix = xplane.get("seam_matrix")
    if not isinstance(matrix, dict) or not isinstance(matrix.get("metrics"), list) or not isinstance(
        matrix.get("seams"), list
    ):
        raise BundleError(f"{path}: xplane section carries no seam matrix")
    for row in matrix["metrics"]:
        if (
            not isinstance(row, dict)
            or not isinstance(row.get("seams"), dict)
            or not isinstance(row.get("tiers"), dict)
            or "metric" not in row
            or sorted(row["seams"]) != sorted(matrix["seams"])
        ):
            raise BundleError(f"{path}: malformed seam-matrix row {row!r}")
    if not isinstance(xplane.get("counters"), dict):
        raise BundleError(f"{path}: xplane section carries no counters")
    return {
        "path": os.fspath(path),
        "reason": doc.get("reason"),
        "rank": doc.get("rank"),
        "incident_id": doc.get("incident_id"),
        "sections": sorted(doc["sections"]),
        "flight_events": len(flight["events"]),
        "flight_last_seq": doc.get("flight_last_seq"),
        "journal_cursor": (doc["sections"]["journal"] or {}).get("cursor"),
        "valid": True,
    }


# -------------------------------------------------------------------------- capture
def _prune(directory: str) -> None:
    """Keep only the newest ``TM_TPU_BUNDLE_KEEP`` bundles in ``directory``."""
    try:
        keep = max(1, int(os.environ.get(ENV_BUNDLE_KEEP, 64)))
    except (TypeError, ValueError):
        keep = 64
    try:
        names = [n for n in os.listdir(directory) if n.endswith(SUFFIX)]
        if len(names) <= keep:
            return
        paths = sorted(
            (os.path.join(directory, n) for n in names), key=lambda p: os.path.getmtime(p)
        )
        for p in paths[: len(paths) - keep]:
            os.unlink(p)
    except OSError:
        pass


def capture_bundle(
    reason: str,
    metric: Optional[Any] = None,
    directory: Optional[Union[str, os.PathLike]] = None,
    merged: bool = False,
    gather_fn: Optional[Callable] = None,
) -> Optional[str]:
    """Capture one post-mortem bundle NOW; returns the written path (or None).

    Fires from every failure seam, so it is best-effort by contract: any capture-time
    error is absorbed into a counted rank-zero warning — a dying process must not die
    twice. Returns None when capture is disabled (``TM_TPU_BUNDLES=0``), when this rank
    is not rank zero in a merged capture, or when capture itself failed.
    """
    global _last_path
    if not _enabled():
        return None
    try:
        # every bundle-capturing seam is an incident seam: mint (or join, within the
        # dedup window) the process-stable id BEFORE building, so the document and
        # the bundle.captured flight event both carry it
        flightrec.open_incident(reason)
        doc = build_bundle(reason, metric=metric, merged=merged, gather_fn=gather_fn)
        if merged and doc["rank"] != 0:
            return None  # contributors hand their payload to rank zero's gather
        from torchmetrics_tpu_torch.robust.checkpoint import atomic_write_bytes

        directory = os.fspath(directory) if directory is not None else _default_dir()
        safe_reason = "".join(c if c.isalnum() or c in "-_." else "-" for c in str(reason))[:64]
        name = f"bundle-{_capture_seq():06d}-{safe_reason}-r{doc['rank']}-p{doc['pid']}{SUFFIX}"
        path = os.path.join(directory, name)
        atomic_write_bytes(path, encode(doc))
        _prune(directory)
        _last_path = path
        telemetry.counter("flight.bundles_captured").inc()
        flightrec.record("bundle.captured", reason=str(reason), path=path)
        return path
    except Exception as err:
        telemetry.counter("flight.bundle_capture_failures").inc()
        rank_zero_warn(
            f"Post-mortem bundle capture for reason {reason!r} failed ({err!r}); the"
            " original failure is unaffected. Set TM_TPU_BUNDLE_DIR to a writable"
            " directory.",
            UserWarning,
        )
        return None


# ----------------------------------------------------------------------- fleet merge
def _collect_bundle_paths(paths: List[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        p = os.fspath(p)
        if os.path.isdir(p):
            out.extend(
                os.path.join(p, n) for n in sorted(os.listdir(p)) if n.endswith(SUFFIX)
            )
        else:
            out.append(p)
    return out


def merge_fleet_bundles(
    paths: List[str],
    incident_id: Optional[str] = None,
    output: Optional[Union[str, os.PathLike]] = None,
) -> str:
    """Assemble per-rank bundles sharing an incident id into ONE validated fleet bundle.

    ``paths`` mixes bundle files and directories (directories are swept for ``.tmb``).
    With ``incident_id=None`` the most common id across the readable bundles is
    chosen; bundles without that id are skipped (named in the warning). The output is
    a full bundle document (its REQUIRED sections captured locally, so
    ``validate_bundle`` holds end to end) plus a ``fleet`` section:

    - ``bundles`` — per source bundle: path, reason, rank/pid, process fingerprint;
    - ``timeline`` — every source's flight events tagged ``peer="r<rank>-p<pid>"``,
      ordered by ``(peer, seq)`` — cross-rank seqs are not globally comparable, so
      the contract is per-peer causal order, peers side by side.

    Returns the written path. Raises :class:`BundleError` when no source matches.
    """
    candidates = _collect_bundle_paths(paths)
    docs: List[Dict[str, Any]] = []
    skipped: List[str] = []
    for p in candidates:
        try:
            docs.append({"path": p, "doc": load_bundle(p, strict=True)})
        except BundleError:
            skipped.append(p)
    if incident_id is None:
        counts: Dict[str, int] = {}
        for d in docs:
            inc = d["doc"].get("incident_id")
            if inc:
                counts[inc] = counts.get(inc, 0) + 1
        if not counts:
            raise BundleError(
                f"no bundle among {len(candidates)} candidate(s) carries an incident id"
            )
        incident_id = max(counts, key=lambda k: counts[k])
    matched = [d for d in docs if d["doc"].get("incident_id") == incident_id]
    if not matched:
        raise BundleError(f"no bundle matches incident id {incident_id!r}")
    skipped.extend(d["path"] for d in docs if d["doc"].get("incident_id") != incident_id)
    if skipped:
        rank_zero_warn(
            f"merge-fleet: skipped {len(skipped)} bundle(s) not matching incident"
            f" {incident_id!r}: {skipped}",
            UserWarning,
        )
    summaries: List[Dict[str, Any]] = []
    timeline: List[Dict[str, Any]] = []
    for d in matched:
        doc = d["doc"]
        peer = f"r{doc.get('rank')}-p{doc.get('pid')}"
        fp = (doc["sections"].get("env") or {}).get("process")
        summaries.append({
            "path": d["path"],
            "peer": peer,
            "reason": doc.get("reason"),
            "rank": doc.get("rank"),
            "pid": doc.get("pid"),
            "fingerprint": fp,
            "captured_unix": doc.get("captured_unix"),
            "flight_last_seq": doc.get("flight_last_seq"),
        })
        for evt in (doc["sections"].get("flight") or {}).get("events", []):
            timeline.append({**evt, "peer": peer})
    timeline.sort(key=lambda e: (e["peer"], e["seq"]))
    fleet_doc = build_bundle(f"fleet-merge-{incident_id}")
    fleet_doc["incident_id"] = incident_id
    fleet_doc["sections"]["fleet"] = {
        "incident_id": incident_id,
        "bundles": summaries,
        "timeline": timeline,
    }
    from torchmetrics_tpu_torch.robust.checkpoint import atomic_write_bytes

    if output is None:
        base = candidates[0]
        directory = base if os.path.isdir(base) else (os.path.dirname(base) or ".")
        safe = "".join(c if c.isalnum() or c in "-_." else "-" for c in incident_id)
        output = os.path.join(directory, f"fleet-{safe}{SUFFIX}")
    output = os.fspath(output)
    atomic_write_bytes(output, encode(fleet_doc))
    telemetry.counter("flight.fleet_merges").inc()
    flightrec.record(
        "bundle.fleet_merged", incident=incident_id, bundles=len(summaries), path=output
    )
    return output


# ------------------------------------------------------------------------ rendering
def inspect_bundle(path: Union[str, os.PathLike], max_events: int = 20) -> str:
    """Human-readable rendering of one bundle (lenient: damaged sections are named)."""
    doc = load_bundle(path, strict=False)
    lines: List[str] = [
        f"bundle {os.fspath(path)}",
        f"  reason:   {doc.get('reason')}",
        f"  rank/pid: {doc.get('rank')}/{doc.get('pid')}",
        f"  incident: {doc.get('incident_id') or '-'}",
        f"  captured: unix={doc.get('captured_unix'):.3f}",
        f"  sections: {', '.join(sorted(doc.get('sections', {})))}",
    ]
    if doc.get("_section_errors"):
        lines.append(f"  DAMAGED:  {doc['_section_errors']}")
    sections = doc.get("sections", {})
    flight = sections.get("flight") or {}
    evts = flight.get("events") or []
    lines.append(
        f"  flight:   {len(evts)} event(s) retained, {flight.get('dropped', 0)} dropped,"
        f" last_seq={flight.get('last_seq')}"
    )
    for evt in evts[-max_events:]:
        extra = {k: v for k, v in evt.items() if k not in ("seq", "ts_us", "kind")}
        lines.append(f"    #{evt['seq']:<6} {evt['ts_us']:>14.1f}us  {evt['kind']:<24} {extra or ''}")
    cursor = (sections.get("journal") or {}).get("cursor")
    lines.append(f"  journal:  cursor={cursor}")
    sync = sections.get("sync")
    if sync:
        lines.append(
            f"  sync:     level={sync.get('world_consistent')}"
            f" degraded={sync.get('degraded_states')} quorum={sync.get('quorum_states')}"
        )
    mem = sections.get("memory") or {}
    totals = mem.get("totals") or {}
    lines.append(
        f"  memory:   resident_bytes={totals.get('resident_bytes')}"
        f" over {totals.get('metrics')} metric(s)"
    )
    metric = sections.get("metric")
    if metric:
        lines.append(
            f"  metric:   {metric.get('class')} updates={metric.get('update_count')}"
            f" gen={metric.get('state_generation')} consistency={metric.get('world_consistent')}"
        )
    fleet = sections.get("fleet")
    if fleet:
        lines.append(
            f"  fleet:    {len(fleet.get('bundles') or [])} bundle(s) merged on"
            f" incident {fleet.get('incident_id')},"
            f" {len(fleet.get('timeline') or [])} timeline event(s)"
        )
        for b in fleet.get("bundles") or []:
            fp = (b.get("fingerprint") or {}).get("fingerprint")
            lines.append(
                f"    {b.get('peer')}: reason={b.get('reason')!r} fingerprint={fp}"
            )
    ranks = sections.get("ranks")
    if ranks:
        lines.append(f"  ranks:    merged view over {len(ranks)} rank(s)")
        for r in ranks:
            mt = r.get("memory_totals") or {}
            lines.append(
                f"    r{r.get('rank')}: flight={len((r.get('flight') or {}).get('events', []))}"
                f" resident_bytes={mt.get('resident_bytes')}"
            )
    env = sections.get("env") or {}
    # a bundle of either package: the JAX package's carries jax_version, this package's torch/CUDA
    runtime = (f"torch={env.get('torch_version')} cuda={env.get('cuda_version')}" if "torch_version" in env
               else f"jax={env.get('jax_version')}")
    lines.append(
        f"  env:      {runtime} backend={env.get('backend')}"
        f" pkg={env.get('package_version')}"
    )
    return "\n".join(lines)


def diff_bundles(path_a: Union[str, os.PathLike], path_b: Union[str, os.PathLike]) -> str:
    """Compare two bundles: counter deltas, flight-window delta, memory movement."""
    a = load_bundle(path_a, strict=False)
    b = load_bundle(path_b, strict=False)
    lines = [f"bundle diff: {os.fspath(path_a)} -> {os.fspath(path_b)}"]
    ca = (a["sections"].get("telemetry") or {}).get("counters", {})
    cb = (b["sections"].get("telemetry") or {}).get("counters", {})
    moved = {k: (ca.get(k, 0), cb.get(k, 0)) for k in sorted(set(ca) | set(cb))
             if ca.get(k, 0) != cb.get(k, 0)}
    lines.append(f"  counters moved: {len(moved)}")
    for k, (va, vb) in moved.items():
        lines.append(f"    {k}: {va} -> {vb} ({vb - va:+d})")
    fa = (a["sections"].get("flight") or {})
    fb = (b["sections"].get("flight") or {})
    lines.append(
        f"  flight: last_seq {fa.get('last_seq')} -> {fb.get('last_seq')}"
        f" (+{max(0, (fb.get('last_seq') or 0) - (fa.get('last_seq') or 0))} events)"
    )
    new_events = [
        e for e in (fb.get("events") or []) if e.get("seq", 0) > (fa.get("last_seq") or 0)
    ]
    for evt in new_events[:40]:
        extra = {k: v for k, v in evt.items() if k not in ("seq", "ts_us", "kind")}
        lines.append(f"    +#{evt['seq']:<6} {evt['kind']:<24} {extra or ''}")
    ta = ((a["sections"].get("memory") or {}).get("totals") or {}).get("resident_bytes")
    tb = ((b["sections"].get("memory") or {}).get("totals") or {}).get("resident_bytes")
    if ta is not None or tb is not None:
        lines.append(f"  memory.resident_bytes: {ta} -> {tb}")
    return "\n".join(lines)


# ------------------------------------------------------------------------------ CLI
def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m torchmetrics_tpu_torch.obs.bundle",
        description="Inspect/validate/diff/merge post-mortem flight bundles",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_inspect = sub.add_parser("inspect", help="render one bundle")
    p_inspect.add_argument("path")
    p_inspect.add_argument("--events", type=int, default=20, help="flight events to show")
    p_validate = sub.add_parser("validate", help="strictly validate bundle(s); exit 0/1")
    p_validate.add_argument("paths", nargs="+")
    p_diff = sub.add_parser("diff", help="compare two bundles")
    p_diff.add_argument("path_a")
    p_diff.add_argument("path_b")
    p_merge = sub.add_parser(
        "merge-fleet",
        help="assemble per-rank bundles sharing an incident id into one fleet bundle",
    )
    p_merge.add_argument("paths", nargs="+", help="bundle files and/or directories")
    p_merge.add_argument("--incident", default=None,
                         help="incident id to merge (default: most common across inputs)")
    p_merge.add_argument("--output", default=None, help="output bundle path")
    args = parser.parse_args(argv)

    if args.cmd == "inspect":
        print(inspect_bundle(args.path, max_events=args.events))
        return 0
    if args.cmd == "merge-fleet":
        try:
            out = merge_fleet_bundles(args.paths, incident_id=args.incident,
                                      output=args.output)
        except BundleError as err:
            print(f"merge-fleet failed: {err}")
            return 1
        print(f"fleet bundle written: {out}")
        return 0
    if args.cmd == "validate":
        bad = 0
        for path in args.paths:
            try:
                summary = validate_bundle(path)
            except BundleError as err:
                print(f"INVALID  {path}: {err}")
                bad += 1
            else:
                print(
                    f"ok       {path}: reason={summary['reason']!r}"
                    f" flight_events={summary['flight_events']}"
                    f" cursor={summary['journal_cursor']}"
                )
        return 1 if bad else 0
    print(diff_bundles(args.path_a, args.path_b))
    return 0


if __name__ == "__main__":
    sys.exit(main())
