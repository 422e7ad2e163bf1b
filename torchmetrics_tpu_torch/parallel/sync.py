"""State sync across processes: the replicated core of ``torchmetrics_tpu/parallel/sync.py``.

Each process holds a full replica of a metric's state (data parallelism, as under DDP). At
``compute`` the replicas are gathered and reduced by each state's ``dist_reduce_fx``:

==================  ============================================================================
reduction            what every rank holds after the sync
==================  ============================================================================
``sum``              the per-rank states added in rank order
``mean``             that sum over the world size
``max`` / ``min``    the elementwise extreme over the ranks
``cat``              the per-rank states concatenated along dim 0, in rank order
``None``             the per-rank states stacked along a new leading world axis
callable             the callable applied to that stack
list state           the per-rank entries, each rank's concatenated before the gather
==================  ============================================================================

Two paths, as in the JAX package:

- :func:`process_sync` (``sync.py:931``), the eager path of ``Metric.compute``: one
  :func:`gather_all_arrays` per state (shapes exchanged, dim 0 padded to the largest, one
  all-gather, each rank's piece trimmed to its own length), then the reduction on the host's
  schedule (:func:`_reduce_gathered`, in rank order, so every rank holds the same bits);
- :func:`sync_state` (``sync.py:653``), the in-program counterpart: ``all_reduce`` and
  all-gathers with no host read, for states of the same shape on every rank.

Every rank joins every collective, in the same order: a rank whose list state is empty still
gathers it. No collective's failure is turned into a local value. Bounded sync (timeouts,
retries, quorum, the rank health ledger), wire compression and the sharded reduce-scatter are not
ported yet (ROADMAP queue A item 9): :class:`SyncOptions` other than the defaults raise.
"""
from __future__ import annotations

import dataclasses
import inspect
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import Tensor

ReduceFx = Union[str, Callable, None]

#: where what is not ported of the JAX module waits
NOT_PORTED = "ROADMAP queue A item 9"
#: the dtypes a gather can carry, by the code the shape exchange sends
_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int64, torch.int32, torch.int16,
           torch.int8, torch.uint8, torch.bool)
#: the most dimensions a gathered state may have
_MAX_NDIM = 8

#: the jitter RNG of the serving tier's blocked-producer park (JAX ``sync.py:76-90``, where it also jitters the
#: bounded sync's retries, not ported yet): seeded from the chaos harness's fixed seed when one is pinned
#: (``TM_TPU_CHAOS_SEED``) so jittered schedules replay under fault injection; free-running entropy otherwise
_BACKOFF_RNG: Optional[Any] = None


def _backoff_rng() -> Any:
    global _BACKOFF_RNG
    if _BACKOFF_RNG is None:
        import random

        seed = os.environ.get("TM_TPU_CHAOS_SEED", "")
        _BACKOFF_RNG = random.Random(int(seed)) if seed.lstrip("-").isdigit() else random.Random()
    return _BACKOFF_RNG


def reset_backoff_rng() -> None:
    """Re-derive the jitter RNG from the current env (tests re-pinning the chaos seed)."""
    global _BACKOFF_RNG
    _BACKOFF_RNG = None


class ConsistencyLevel(str):
    """Grade of a sync: ``full | quorum | local`` (``sync.py:92``). ``bool(level)`` is True only
    for ``full``. The replicated path always grades ``full``; the other grades come from bounded
    sync, which is not ported yet."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return str.__eq__(self, "full")


FULL = ConsistencyLevel("full")
QUORUM = ConsistencyLevel("quorum")
LOCAL = ConsistencyLevel("local")


def as_consistency(value: Any) -> ConsistencyLevel:
    """A bool or raw string consistency flag as its grade (``sync.py:112``)."""
    if isinstance(value, ConsistencyLevel):
        return value
    if isinstance(value, str):
        if value == "quorum":
            return QUORUM
        return FULL if value == "full" else LOCAL
    return FULL if value else LOCAL


@dataclasses.dataclass(frozen=True)
class SyncOptions:
    """The JAX package's sync policy (``sync.py:124``), with its fields and defaults.

    Only the defaults are supported: an unbounded gather of the whole world, uncompressed. Any
    other value (a timeout, a quorum, a world override, a compression mode, ...) raises
    ``NotImplementedError``: bounded, quorum and compressed sync are ROADMAP queue A item 9.
    """

    timeout_s: float = 0.0
    retries: int = 2
    backoff_s: float = 0.05
    backoff_jitter: bool = True
    degraded_mode: bool = True
    quorum: Optional[Union[int, float]] = None
    quorum_rescale: bool = True
    world: Optional[int] = None
    evict_after: int = 3
    probe_backoff_s: float = 1.0
    compression: str = "none"

    def __post_init__(self) -> None:
        changed = [f.name for f in dataclasses.fields(self) if getattr(self, f.name) != f.default]
        if changed:
            raise NotImplementedError(
                f"SyncOptions({', '.join(f'{n}={getattr(self, n)!r}' for n in changed)}): bounded, quorum and"
                f" compressed sync are not ported yet ({NOT_PORTED}); only the default options are supported"
            )


class SyncedState(dict):
    """:func:`process_sync`'s result (``sync.py:228``): the synced state dict, with the fields the
    replicated path fills. ``gather_latency_us`` maps each state to the wall time of its gather on
    this rank; ``bytes_shipped`` counts this rank's payloads, ``bytes_received`` the gathered
    pieces it holds after the trim; ``responding_ranks`` maps each state to the ranks it covers."""

    world_consistent: ConsistencyLevel = FULL
    responding_ranks: Dict[str, Tuple[int, ...]] = {}
    gather_latency_us: Dict[str, float] = {}
    bytes_shipped: int = 0
    bytes_received: int = 0


# ------------------------------------------------------------------ the process group
def _initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def distributed_available() -> bool:
    """True when ``torch.distributed`` is initialised with a world above 1 (JAX ``metric.py:69``)."""
    return _initialised() and dist.get_world_size() > 1


def _world_size(group: Optional[Any] = None) -> int:
    return dist.get_world_size(group) if _initialised() else 1


def _local_rank(group: Optional[Any] = None) -> int:
    return dist.get_rank(group) if _initialised() else 0


def _wire_device(group: Optional[Any]) -> torch.device:
    """Where a collective's tensors live, by the group's backend: the current card for NCCL, the
    host for every other backend (gloo's CUDA support does not cover every collective)."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather_single(out: Tensor, value: Tensor, group: Optional[Any]) -> None:
    """The ranks' ``value`` concatenated along dim 0 into ``out``: ``all_gather_single``, named
    ``all_gather_into_tensor`` before PyTorch 2.12."""
    (getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor)(out, value, group=group)


def _to_wire(value: Tensor, device: torch.device) -> Tensor:
    """``value`` on ``device``, contiguous, bool carried as uint8 (NCCL has no bool type)."""
    value = value.to(device)
    return (value.to(torch.uint8) if value.dtype == torch.bool else value).contiguous()


# ------------------------------------------------------------------ the eager gather
def _gather_meta(shape: Tuple[int, ...], dtype: torch.dtype, group: Optional[Any]) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
    """Every rank's (shape, dtype), by one all-gather of a small int64 tensor, read on the host.
    Ranks may differ in ``ndim``."""
    if len(shape) > _MAX_NDIM:
        raise ValueError(f"Cannot gather a state of {len(shape)} dimensions; at most {_MAX_NDIM} are supported")
    if dtype not in _DTYPES:
        raise ValueError(f"Cannot gather a state of dtype {dtype}; the supported dtypes are {_DTYPES}")
    row = [_DTYPES.index(dtype), len(shape), *shape] + [0] * (_MAX_NDIM - len(shape))
    device = _wire_device(group)
    world = dist.get_world_size(group)
    out = torch.empty((world, len(row)), dtype=torch.int64, device=device)
    _all_gather_single(out, torch.tensor([row], dtype=torch.int64, device=device), group)
    return [(tuple(r[2:2 + r[1]]), _DTYPES[r[0]]) for r in out.tolist()]


def all_gather_object_shapes(local_shape: tuple, group: Optional[Any] = None) -> List[tuple]:
    """Every rank's shape of a state (``sync.py:697``, reference ``distributed.py:118-127``)."""
    if not _initialised():
        return [tuple(local_shape)]
    return [shape for shape, _ in _gather_meta(tuple(local_shape), torch.float32, group)]


def gather_all_arrays(value: Tensor, group: Optional[Any] = None) -> List[Tensor]:
    """``value`` from every rank of ``group``, in rank order (``sync.py:705``, reference
    ``gather_all_tensors``, ``distributed.py:97-147``).

    Without an initialised process group it returns ``[value]``. Under one, a world of 1
    included (there NCCL runs its all-gather on the card too), it exchanges every rank's shape and
    dtype, pads dim 0 to the largest, all-gathers once, and trims each rank's piece to its own
    length: ranks may hold different numbers of rows. A rank with no rows (an empty list state's
    placeholder, or an idle rank's empty ``cat`` state) takes the dtype and trailing shape of the
    first rank that has rows, so the pieces concatenate without a cast.

    The device is chosen by the backend, never by a caught error: on a NCCL group the payload
    stays on the card; on any other backend (gloo) it is copied to the host for the collective,
    and each piece is copied back to ``value``'s device, because gloo's CUDA support does not cover
    every collective. Each piece is returned on ``value``'s device.
    """
    if not _initialised():
        return [value]
    meta = _gather_meta(tuple(value.shape), value.dtype, group)
    scalar = all(len(shape) == 0 for shape, _ in meta)
    if scalar:
        meta = [((1,), dtype) for _, dtype in meta]
    elif any(len(shape) == 0 for shape, _ in meta):
        raise ValueError(f"Cannot gather a state that is a scalar on some ranks and not on others: {meta}")
    rows = [shape[0] for shape, _ in meta]
    donor = next((m for m, n in zip(meta, rows) if n > 0), meta[0])
    trailing, dtype = donor[0][1:], donor[1]
    for (shape, d), n in zip(meta, rows):
        if n > 0 and (shape[1:] != trailing or d != dtype):
            raise ValueError(f"Cannot gather a state whose ranks hold rows of different shapes or dtypes: {meta}")
    world, own = len(meta), rows[_local_rank(group)]
    if max(rows) == 0:  # every rank is empty: no rows to gather
        return [torch.empty((0, *trailing), dtype=dtype, device=value.device) for _ in range(world)]
    device = _wire_device(group)
    local = _to_wire(value.reshape(own, *trailing).to(dtype), device)
    if own < max(rows):
        local = torch.cat([local, local.new_zeros((max(rows) - own, *trailing))])
    out = local.new_empty((world * max(rows), *trailing))
    _all_gather_single(out, local, group)
    pieces = out.view(world, max(rows), *trailing)
    gathered = [pieces[r, :rows[r]].to(device=value.device, dtype=dtype) for r in range(world)]
    return [g.reshape(()) for g in gathered] if scalar else gathered


def _reduce_gathered(fx: ReduceFx, vals: List[Tensor]) -> Any:
    """The reduction of the per-rank states, in rank order (``sync.py:770``); every rank runs the
    same operations on the same pieces, so every rank holds the same bits. ``len(vals)`` is the
    world: the replicated path has no partial world to rescale."""
    if fx in ("sum", "mean"):
        total = vals[0]
        for v in vals[1:]:
            total = total + v
        if fx == "sum":
            return total
        return (total if total.is_floating_point() else total.to(torch.float32)) / len(vals)
    if fx in ("max", "min"):
        out = vals[0]
        for v in vals[1:]:
            out = torch.maximum(out, v) if fx == "max" else torch.minimum(out, v)
        return out
    if fx == "cat":
        return torch.cat([torch.atleast_1d(v) for v in vals], dim=0)
    if fx is None:
        return torch.stack(vals)
    if callable(fx):
        return fx(torch.stack(vals))
    raise ValueError(f"Unsupported dist_reduce_fx: {fx!r}")


def _nbytes(value: Any) -> int:
    if isinstance(value, (list, tuple)):
        return sum(_nbytes(v) for v in value)
    return value.numel() * value.element_size() if isinstance(value, Tensor) else 0


def _takes_name(gather: Callable) -> bool:
    try:
        params = inspect.signature(gather).parameters
    except (TypeError, ValueError):
        return False
    return "name" in params or any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values())


def process_sync(
    state: Dict[str, Any],
    reductions: Dict[str, ReduceFx],
    gather_fn: Optional[Callable] = None,
    group: Optional[Any] = None,
    options: Optional[SyncOptions] = None,
    device: Union[str, torch.device, None] = None,
) -> SyncedState:
    """Gather every state of ``state`` across the world and reduce it by its ``reductions`` entry
    (``sync.py:931``, its replicated path ``:1129-1221``).

    ``gather_fn(value, group)`` returns the list of every rank's ``value`` (default
    :func:`gather_all_arrays`); one that takes a ``name`` keyword gets the state's name, so an
    injected gather (an emulated world) can key by state instead of matching values. Every state
    is gathered, in the order of ``state``, on every rank:

    - a list state's entries are concatenated before the gather; an empty list gathers a float32
      ``(0,)`` placeholder on ``device`` (which :func:`gather_all_arrays` gives the other ranks'
      dtype and trailing shape), and the result keeps each rank's non-empty piece, in rank order:
      ``[]`` when every rank is empty;
    - one gathered entry (a world of 1) is returned as it is, with no world axis (``sync.py:1219``);
    - otherwise :func:`_reduce_gathered` reduces the entries.

    ``options`` must be the default :class:`SyncOptions`; ``device`` places the empty placeholder
    (default: the device of the first tensor of ``state``, else the host).
    """
    del options  # the defaults are the only options SyncOptions admits
    gather = gather_fn or gather_all_arrays
    kw_name = _takes_name(gather)
    if device is None:
        first = next((v for v in state.values() if isinstance(v, Tensor)), None)
        device = first.device if first is not None else torch.device("cpu")
    out = SyncedState()
    latency: Dict[str, float] = {}
    responding: Dict[str, Tuple[int, ...]] = {}
    shipped = received = 0
    for name, value in state.items():
        is_list = isinstance(value, (list, tuple))
        if is_list:
            payload = (torch.cat([torch.atleast_1d(v) for v in value], dim=0) if value
                       else torch.empty((0,), dtype=torch.float32, device=device))
        else:
            payload = value
        t0 = time.perf_counter()
        gathered = list(gather(payload, group, name=name) if kw_name else gather(payload, group))
        latency[name] = (time.perf_counter() - t0) * 1e6
        responding[name] = tuple(range(len(gathered)))
        shipped += _nbytes(payload)
        received += _nbytes(gathered)
        if is_list:
            out[name] = [g for g in gathered if g.ndim == 0 or g.shape[0] > 0]
        elif len(gathered) == 1:
            out[name] = gathered[0]
        else:
            out[name] = _reduce_gathered(reductions.get(name, "sum"), gathered)
    out.world_consistent = FULL
    out.responding_ranks = responding
    out.gather_latency_us = latency
    out.bytes_shipped = shipped
    out.bytes_received = received
    return out


# ------------------------------------------------------------------ the in-program collective
def _reduce_one(value: Tensor, fx: ReduceFx, group: Optional[Any], world: int) -> Tensor:
    """One state through its collective (``sync.py:632``), on the wire device."""
    if fx in ("sum", "mean", "max", "min"):
        op = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[fx]
        dist.all_reduce(value, op=op, group=group)
        return value / world if fx == "mean" else value  # gloo has no AVG
    flat = torch.atleast_1d(value)
    out = flat.new_empty((world * flat.shape[0], *flat.shape[1:]))
    _all_gather_single(out, flat, group)
    if fx == "cat":
        return out
    stacked = out.view(world, *value.shape)
    if fx is None:
        return stacked
    if callable(fx):
        return fx(stacked)
    raise ValueError(f"Unsupported dist_reduce_fx: {fx!r}")


def sync_state(state: Dict[str, Any], reductions: Dict[str, ReduceFx], group: Optional[Any] = None) -> Dict[str, Any]:
    """Synchronise a state dict across ``group`` with collectives and no host read (``sync.py:653``):
    ``all_reduce`` for ``sum``, ``max`` and ``min``; ``mean`` as the sum over the world size;
    ``all_gather`` into one tensor for ``cat``; a stacked all-gather for ``None`` and callables.

    As JAX's in-program collective does, it needs every rank to hold each state in the same shape
    and dtype; list states are concatenated first and gathered as ``cat``, and an empty list stays
    empty (it must be empty on every rank). Integer states come back exact; float sums are added in
    the backend's order. On a non-NCCL group the tensors go through the host, as in
    :func:`gather_all_arrays`. Without an initialised process group the state is returned as it is.
    """
    if not _initialised():
        return dict(state)
    world = _world_size(group)
    device = _wire_device(group)
    out: Dict[str, Any] = {}
    for name, value in state.items():
        fx = reductions.get(name, "sum")
        if isinstance(value, (list, tuple)):
            if not value:
                out[name] = list(value)
                continue
            value, fx = torch.cat([torch.atleast_1d(v) for v in value], dim=0), ("cat" if fx in (None, "cat") else fx)
            wrap = True
        else:
            wrap = False
        wire = _to_wire(value, device)
        if wire is value:
            wire = wire.clone()  # the collective writes in place; the caller's state stays
        synced = _reduce_one(wire, fx, group, world)
        if value.dtype == torch.bool and synced.dtype == torch.uint8:
            synced = synced.to(torch.bool)
        synced = synced.to(value.device)
        out[name] = [synced] if wrap else synced
    return out


__all__ = [
    "FULL",
    "LOCAL",
    "NOT_PORTED",
    "QUORUM",
    "ConsistencyLevel",
    "ReduceFx",
    "SyncOptions",
    "SyncedState",
    "all_gather_object_shapes",
    "as_consistency",
    "distributed_available",
    "gather_all_arrays",
    "process_sync",
    "sync_state",
]
