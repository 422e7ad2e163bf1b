"""Base class of the port's metrics: the core lifecycle and its dispatch tiers.

Counterpart of ``torchmetrics_tpu/metric.py``: ``add_state`` (``:338``), ``update`` with its
``fast_update`` tier (``:495-532``), ``update_batches`` (``:534``), the reduce-state ``forward``
fused into one step (``_jitted_forward_step`` ``:936``, ``_fast_forward_step`` ``:1060``, merged by
``_merge_tensor_ladder`` ``:909``), the ``full_state_update`` forward (``:831``), ``buffered``
(``:1114``), ``compute`` with its cache (``:1468``), ``reset`` (``:1500``), ``clone`` and pickling
(``:1629-1700``), ``state_dict`` / ``load_state_dict`` (``:1706``, ``:1727``), ``to`` (``:1838``),
``set_dtype`` (``:1873``), the operators with ``CompositionalMetric`` (``:1943-2120``), and state
sync: the base keywords (``:188-209``), ``sync`` / ``unsync`` / ``sync_context`` (``:1310-1441``),
``compute`` under ``sync_context`` with ``compute_with_cache`` (``:1468-1498``), and the
``dist_sync_on_step`` forward (``:860-877``). Telemetry (``obs``): the JAX engine's hooks at the
same points (``metric.py:452-1484``): per-instance call counts and spans around ``update``,
``update_batches``, ``forward``, ``compute`` and ``sync``, one ``count_dispatch`` per graph replay or
eager step, the sketch counters after an update (``:532``), and ``Metric.telemetry`` (``:286``). The
robust layer (``robust/``): ``nan_policy`` through ``_effective_update``, which every tier builds its step
from (``:412-430``), with ``nan_poison_count`` and the check at ``compute`` (``:1527-1575``); ``snapshot`` /
``restore`` (``:1590-1605``); ``journal`` and ``buffered(k, journal=...)`` (``:1114-1147``). And ``plot``
(``:1931``). The serving tier (``serve/``): ``serve`` and ``update_async`` (``:1178-1245``), the quiesce of the
ingestion window at every host access path, ``dump_diagnostics`` (``:1609``) and the post-mortem bundle at
``nan_policy="raise"`` (``:1565``).

Subclass contract, as in the JAX package:

- call :meth:`add_state` in ``__init__`` for every accumulator;
- implement ``_update(state, *args, **kwargs) -> dict``, a pure function from the dict of tensor
  states and a batch to the new tensor states; for a list state, the dict holds the entry to
  append under the state's name;
- implement ``_compute(state) -> value``; list states arrive concatenated.

Dispatch tiers (``ops/dispatch.py``). On the card, a fused step (a forward, a ``fast_update``
update, an ``update_batches`` sweep) runs as one captured CUDA graph per input signature, whose
replays update the tensor states in place in static buffers. Everywhere else, and for list states,
``jit_update=False`` or ``TM_TPU_FAST_DISPATCH=0``, the same step runs eagerly and replaces the
state tensors with new ones. Both tiers run the same operations in the same order, so they give
bit-identical state. What holds across the tiers:

- code that replaces a state (``reset``, ``load_state_dict``, ``_set_states``, an eager step)
  stays correct: the next graph step copies the replaced state back into its static buffers;
- the members of a ``MetricCollection`` compute group hold the leader's state tensors, which are
  the leader's static buffers on the graph tier, so they see every replay;
- no tensor handed to a caller (``metric_state``, ``state_dict``, ``compute``, a forward's batch
  value) changes after a later step: each is a copy or a fresh tensor;
- reading the state while a step is in flight raises (``StateStore.guard_readable``).

Every metric holds an explicit ``torch.device``. ``device=None`` means CUDA, and raises when no
CUDA device is present; pass ``device="cpu"`` to run on the CPU.

Sync (``parallel/sync.py``). ``compute`` gathers and reduces the states across the processes of
``torch.distributed`` when a world above 1 is initialised (or ``distributed_available_fn`` says so,
or a ``dist_sync_fn`` is given), then puts the local state back. The gather reads sizes on the
host, so it never runs inside a captured step; ``sync`` replaces the state's dict entries and
``unsync`` puts back the same tensor objects, which on the graph tier are the static buffers.
"""
from __future__ import annotations

import inspect
from contextlib import contextmanager
from copy import deepcopy
from typing import Any, Callable, Dict, Generator, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import Tensor
from torch.utils._pytree import tree_map

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.ops import dispatch as _dispatch
from torchmetrics_tpu_torch.parallel.sync import (
    FULL,
    SyncOptions,
    as_consistency,
    distributed_available,
    process_sync,
    sync_options_from_env,
)
from torchmetrics_tpu_torch.robust import guardrails as _guardrails
from torchmetrics_tpu_torch.utils.data import dim_zero_cat
from torchmetrics_tpu_torch.utils.exceptions import NumericPoisonError, TorchMetricsUserError, TorchMetricsUserWarning
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

_REDUCTIONS = ("sum", "mean", "cat", "min", "max", None)
_FUSABLE_REDUCTIONS = ("sum", "mean", "max", "min")
_MISS = _dispatch.MISS


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device a metric lives on: CUDA unless the caller names another; raises if CUDA is absent."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise TorchMetricsUserError(
                "torchmetrics_tpu_torch metrics run on CUDA unless told otherwise, and no CUDA device is"
                " available; pass device='cpu' to run on the CPU."
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class StateStore:
    """A metric's state (reference ``metric.py:90-139``).

    ``generation`` counts the graph steps that wrote the state buffers in place; ``inflight`` is
    True only while a graph step runs, when the buffers are between two states.
    """

    def __init__(self) -> None:
        self.tensors: Dict[str, Tensor] = {}
        self.lists: Dict[str, List[Tensor]] = {}
        self.generation = 0
        self.inflight = False

    def bump_generation(self) -> None:
        """Move the generation as a foreign graph step would: the seam that tests and chaos use to break the
        serving tier's generation fence (the JAX package's tests call ``commit_donated`` for this)."""
        self.generation += 1

    def guard_readable(self) -> None:
        if self.inflight:
            raise TorchMetricsUserError(
                "Metric state read mid-flight: a graph step is writing the state buffers in place."
                " Do not read state from callbacks that run inside a forward step."
            )


def _merge_tensor_ladder(global_tensors: Dict[str, Tensor], batch_out: Dict[str, Any], defaults: Dict[str, Tensor],
                         reductions: Dict[str, Optional[str]], n: Optional[Tensor]) -> Dict[str, Tensor]:
    """Merge a batch contribution into the global tensors by their reductions (reference
    ``metric.py:909-934``), the one merge of both tiers; ``n`` is the update count including
    this batch, a float32 device scalar, read only by ``mean`` states."""
    merged = {}
    for name, gv in global_tensors.items():
        if name not in batch_out:
            merged[name] = gv
            continue
        bv = batch_out[name]
        fx = reductions[name]
        if fx == "sum":
            # the batch state includes the default; sum states have zero defaults
            merged[name] = gv + (bv - defaults[name])
        elif fx == "mean":
            nf = n.to(bv.dtype)
            merged[name] = ((nf - 1) * gv + bv) / nf
        elif fx == "max":
            merged[name] = torch.maximum(gv, bv)
        elif fx == "min":
            merged[name] = torch.minimum(gv, bv)
        elif fx == "cat":
            merged[name] = torch.cat([gv, bv], dim=0)
        elif callable(fx):
            merged[name] = fx(torch.stack([gv, bv]))
        else:
            raise TorchMetricsUserError(f"Cannot reduce states with `dist_reduce_fx={fx}` in forward.")
    return merged


def _fold(update: Callable, state: Dict[str, Tensor], args: tuple, kwargs: dict) -> Dict[str, Tensor]:
    """``state`` after ``update`` of each batch of a stack, in order (the body of JAX's ``lax.scan``)."""
    n_batches = (args[0] if args else next(iter(kwargs.values()))).shape[0]
    for i in range(n_batches):
        out = update(state, *(a[i] for a in args), **{k: v[i] for k, v in kwargs.items()})
        state = {k: out.get(k, v) for k, v in state.items()}
    return state


class Metric:
    """Base class for all metrics of the port (reference ``metric.py:50``).

    The comparison operators build a :class:`CompositionalMetric`, so a metric is hashed by
    identity (a class that defines ``__eq__`` loses ``object.__hash__``), and code that compares
    metric objects tests identity (``is``, ``id``).
    """

    __hash__ = object.__hash__

    is_differentiable: Optional[bool] = None
    higher_is_better: Optional[bool] = None
    full_state_update: Optional[bool] = False
    plot_lower_bound: Optional[float] = None
    plot_upper_bound: Optional[float] = None
    plot_legend_name: Optional[str] = None
    # engine flags (reference metric.py:167-182)
    #: the update is capturable (no host read, no dynamic shape); False keeps it eager
    jit_update: bool = True
    #: the compute is capturable, so a forward's batch value can run inside the step's graph
    jit_compute: bool = True
    #: False folds ``update_batches`` with a loop of eager updates
    scan_update: bool = True
    #: False opts this class out of the graph tier
    fast_dispatch: bool = True
    #: opt-in graph tier for plain ``update`` calls (``forward`` and ``update_batches`` have theirs)
    fast_update: bool = False
    #: the keyed engine's decomposition hint (``torchmetrics_tpu_torch.keyed``): True forces its
    #: segments strategy, False its vmap strategy, None decides from the reductions
    keyed_decomposable: Optional[bool] = None
    #: the async ingestion engine (``torchmetrics_tpu_torch.serve``), None until ``serve``/``update_async``
    #: opts in; the disabled path costs one attribute check per host access
    _serve: Optional[Any] = None

    def __init__(self, device: Union[str, torch.device, None] = None, **kwargs: Any) -> None:
        """``device`` is the port's own keyword; the others are the JAX package's base keywords
        (``metric.py:188-209``), checked as it checks them: ``compute_on_cpu`` (list-state entries
        move to the host after each update), ``dist_sync_on_step`` (a forward's batch value is
        synced), ``process_group``, ``dist_sync_fn``, ``distributed_available_fn``,
        ``sync_on_compute``, ``compute_with_cache``, ``nan_policy`` (``robust/guardrails.py``: with a
        policy other than ``"propagate"`` a float32 poison counter joins the states) and
        ``sync_options`` (a :class:`~torchmetrics_tpu_torch.parallel.sync.SyncOptions`: bounded, quorum and
        degraded sync; ``None`` reads the ``TM_TPU_SYNC_*`` environment at each sync). Any other keyword raises
        ``ValueError``."""
        self.compute_on_cpu = kwargs.pop("compute_on_cpu", False)
        self.dist_sync_on_step = kwargs.pop("dist_sync_on_step", False)
        if not isinstance(self.dist_sync_on_step, bool):
            raise ValueError("Expected keyword argument `dist_sync_on_step` to be a `bool`")
        self.process_group = kwargs.pop("process_group", None)
        self.dist_sync_fn = kwargs.pop("dist_sync_fn", None)
        if self.dist_sync_fn is not None and not callable(self.dist_sync_fn):
            raise ValueError("Expected keyword argument `dist_sync_fn` to be callable or None")
        self.distributed_available_fn = kwargs.pop("distributed_available_fn", None) or distributed_available
        self.sync_on_compute = kwargs.pop("sync_on_compute", True)
        if not isinstance(self.sync_on_compute, bool):
            raise ValueError("Expected keyword argument `sync_on_compute` to be a `bool`")
        self.compute_with_cache = kwargs.pop("compute_with_cache", True)
        if not isinstance(self.compute_with_cache, bool):
            raise ValueError("Expected keyword argument `compute_with_cache` to be a `bool`")
        self._nan_policy = _guardrails.validate_policy(kwargs.pop("nan_policy", "propagate"))
        self.sync_options = kwargs.pop("sync_options", None)
        if self.sync_options is not None and not isinstance(self.sync_options, SyncOptions):
            raise ValueError("Expected keyword argument `sync_options` to be a SyncOptions or None")
        if kwargs:
            kwargs_ = [f"`{a}`" for a in sorted(kwargs)]
            raise ValueError(f"Unexpected keyword arguments: {', '.join(kwargs_)}")
        self._device = resolve_device(device)
        self._dtype = torch.float32
        self._defaults: Dict[str, Union[Tensor, List]] = {}
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, Optional[str]] = {}
        self._state = StateStore()
        self._graphs = _dispatch.GraphCache()
        self._buffered_pending = 0
        self._update_count = 0
        self._update_called = False
        self._computed: Any = None
        self._to_sync = self.sync_on_compute
        self._should_unsync = True
        self._is_synced = False
        self._cache: Optional[Dict[str, Any]] = None
        self._world_consistent = FULL
        # telemetry (obs): always-on integer counts, and wall times while tracing is on
        self._tm_counts: Dict[str, int] = {}
        self._tm_times: Dict[str, float] = {}
        self._tm_retrace_warned = False
        if self._nan_policy != "propagate":
            # the poison counter rides the ordinary state machinery (JAX metric.py:236-242): sum-reduced,
            # reset by reset(), captured, folded and buffered like any accumulator, read once at compute()
            self.add_state(_guardrails.POISON_STATE, torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    # ------------------------------------------------------------------ state
    @property
    def dtype(self) -> torch.dtype:
        """The float dtype the states were last cast to by :meth:`set_dtype` (JAX ``metric.py:253``):
        ``torch.float32`` until then."""
        return self._dtype

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def update_called(self) -> bool:
        return self._update_called

    @property
    def update_count(self) -> int:
        return self._update_count

    @property
    def nan_policy(self) -> str:
        """The numeric guardrail policy (JAX ``metric.py:1527``): ``propagate``, ``raise``, ``warn`` or ``mask``."""
        return self._nan_policy

    @property
    def nan_poison_count(self) -> int:
        """Non-finite input values counted by the guardrail so far (JAX ``metric.py:1532``); always 0 under
        ``"propagate"``, which keeps no counter. The one host read of the counter."""
        if self.nan_policy == "propagate":
            return 0
        self._quiesce()  # the accumulator is drain-mutated state
        self._state.guard_readable()
        return int(self._state.tensors[_guardrails.POISON_STATE].item())

    def _guard_poison(self) -> None:
        """The guardrail's check at finalisation (JAX ``metric.py:1546-1575``)."""
        policy = self.nan_policy
        if policy == "propagate":
            return
        cnt = self.nan_poison_count
        if not cnt:
            return
        obs.telemetry.counter("robust.nonfinite_detected").inc(cnt)
        obs.flightrec.record("nan.poison", metric=type(self).__name__, count=cnt, policy=policy)
        msg = f"{type(self).__name__} accumulated {cnt} non-finite input value(s) (nan_policy={policy!r})."
        if policy == "raise":
            # the state is unusable from here: land the post-mortem bundle BEFORE the raise, so the flight
            # ring and counters survive the process that dies on it
            obs.capture_bundle("nan_poison", metric=self)
            raise NumericPoisonError(msg + " The accumulator state is poisoned; reset() or restore() a clean snapshot.")
        if policy == "warn":
            rank_zero_warn(msg + " The computed value may be numerically poisoned.", TorchMetricsUserWarning)
        # "mask": the values never reached the accumulators; the count is informational

    @property
    def world_consistent(self) -> Any:
        """The grade of the last sync, ``full | quorum | local`` (JAX ``metric.py:1576``): truthy only
        for ``full``. ``quorum`` means at least one state was aggregated over a responding subset (a timeout
        quorum, or an evicted rank left out of the gather group); ``local`` means a state fell back to this
        process's value. The next fully successful sync, or ``reset``, sets it back to ``full``;
        ``telemetry["sync"]`` carries the details of the last sync."""
        return self._world_consistent

    @property
    def telemetry(self) -> Dict[str, Any]:
        """Per-instance observability snapshot (JAX ``metric.py:286-310``): call counts, graph
        captures per step kind (``traces``; the port's counterpart of a jit trace), device steps
        (``dispatches``: graph replays and eager steps), and, when tracing was enabled,
        accumulated wall times. ``retraces`` counts captures beyond each kind's first: nonzero
        after a shape or dtype change in the inputs. It survives ``clone`` and pickling."""
        counts = dict(self.__dict__.get("_tm_counts") or {})
        times = self.__dict__.get("_tm_times") or {}
        traces = {k.split(".", 1)[1]: v for k, v in counts.items() if k.startswith("traces.")}
        retraces = {k: max(0, v - 1) for k, v in traces.items()}
        out = {
            "calls": {k[: -len("_calls")]: v for k, v in counts.items() if k.endswith("_calls")},
            "dispatches": counts.get("dispatches", 0),
            "traces": traces,
            "retraces": retraces,
            "retraces_total": sum(retraces.values()),
            "time_s": {k: round(v, 6) for k, v in times.items()},
        }
        last_sync = self.__dict__.get("_tm_last_sync")
        if last_sync is not None:
            out["sync"] = dict(last_sync)
        return out

    @property
    def _tensors(self) -> Dict[str, Tensor]:
        return self._state.tensors

    @property
    def _lists(self) -> Dict[str, List[Tensor]]:
        return self._state.lists

    @property
    def metric_state(self) -> Dict[str, Any]:
        """A copy of the current state values (reference ``metric.py:186``): later steps, which
        may write the state in place, do not change it."""
        _dispatch.guard_buffered_pending(self, "metric_state")
        self._quiesce()
        self._state.guard_readable()
        return {**{k: v.clone() for k, v in self._state.tensors.items()},
                **{k: list(v) for k, v in self._state.lists.items()}}

    @property
    def state_generation(self) -> int:
        """Graph steps that wrote the state buffers in place (reference ``metric.py:277``)."""
        return self._state.generation

    def add_state(
        self,
        name: str,
        default: Any,
        dist_reduce_fx: Optional[str] = None,
        persistent: bool = False,
    ) -> None:
        """Register an accumulator (reference ``metric.py:194-271``).

        ``default`` is a tensor (tensor state) or an empty list (list state). ``dist_reduce_fx``
        is one of ``sum``, ``mean``, ``cat``, ``min``, ``max``, None, or a callable that folds a
        stack of states along its leading axis (applied by sync, and by the eager forward's merge).
        """
        if isinstance(default, list):
            if default:
                raise ValueError("state variable must be a tensor or any empty list (where you can append tensors)")
        else:
            try:
                default = torch.as_tensor(default, device=self._device).clone()
            except (TypeError, ValueError, RuntimeError):
                raise ValueError("state variable must be a tensor or any empty list (where you can append tensors)")
        if not (callable(dist_reduce_fx) or dist_reduce_fx in _REDUCTIONS):
            raise ValueError("`dist_reduce_fx` must be callable or one of ['mean', 'sum', 'cat', 'min', 'max', None]")
        self._defaults[name] = default
        self._persistent[name] = persistent
        self._reductions[name] = dist_reduce_fx
        if isinstance(default, list):
            self._state.lists[name] = []
        else:
            self._state.tensors[name] = default
        self._graphs = _dispatch.GraphCache()

    # ------------------------------------------------------------- subclass API
    def _update(self, state: Dict[str, Tensor], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        raise NotImplementedError

    def _compute(self, state: Dict[str, Any]) -> Any:
        raise NotImplementedError

    def _validate(self, *args: Any, **kwargs: Any) -> None:
        """Host-side input checks; subclasses override this when they validate their inputs."""

    def _should_validate(self) -> bool:
        """Whether host-side validation runs at all (reference ``metric.py:483``): not for a class
        without ``_validate``, nor when the caller turned ``validate_args`` off."""
        if type(self)._validate is Metric._validate:
            return False
        return bool(getattr(self, "validate_args", True))

    # ------------------------------------------------------------------ engine
    def _effective_update(self) -> Callable:
        """The update every dispatch tier builds its step from (JAX ``metric.py:413``): ``_update`` itself,
        or under a ``nan_policy`` its guardrail wrapper, which counts (and under ``"mask"`` zeroes) the
        non-finite batch values inside the same step."""
        policy = self.nan_policy
        if policy == "propagate":
            return self._update
        return _guardrails.guarded_update(self._update, policy)

    def _coerce(self, args: tuple, kwargs: dict) -> tuple:
        """Inputs as tensors on this metric's device."""

        def conv(x: Any) -> Any:
            if isinstance(x, Tensor):
                return x if x.device == self._device else x.to(self._device)
            if isinstance(x, (np.ndarray, np.generic, int, float, bool)) or (
                isinstance(x, (list, tuple)) and len(x) and isinstance(x[0], (int, float, bool))
            ):
                return torch.as_tensor(x, device=self._device)
            return x

        return tuple(conv(a) for a in args), {k: conv(v) for k, v in kwargs.items()}

    def _default_state(self) -> Dict[str, Tensor]:
        return {k: self._defaults[k] for k in self._state.tensors}

    def _bump(self, n: int = 1) -> None:
        self._update_count += n
        self._update_called = True
        self._computed = None

    def _append(self, out: Dict[str, Any]) -> None:
        """Append a step's list-state entries; with ``compute_on_cpu`` they move to the host
        (JAX ``metric.py:740``)."""
        for name, entries in self._state.lists.items():
            if name in out:
                entry = out[name]
                new = list(entry) if isinstance(entry, (list, tuple)) else [entry]
                entries.extend([e.cpu() for e in new] if self.compute_on_cpu else new)

    def _graph_gate(self, op: str, *, fast_update: bool = False, reads_state: bool = True) -> bool:
        """Whether ``op`` may run on the graph tier; otherwise notes the reason (reference
        ``_note_tier_fallback``, ``metric.py:961``). A step that does not read the state
        (``reads_state=False``) is not held back by list states or by ``jit_update``."""
        if fast_update and not self.fast_update:
            reason = "fast_update_class_off"
        elif reads_state and not self.jit_update:
            reason = "jit_update_off"
        elif not self.fast_dispatch:
            reason = "fast_dispatch_class_off"
        elif reads_state and self._state.lists:
            reason = "list_state"
        elif not _dispatch.fast_dispatch_enabled():
            reason = "fast_dispatch_env_off"
        elif not _dispatch.graph_device(self._device):
            reason = "cpu_device"
        else:
            return True
        _dispatch.STATS.note_fallback(self, op, reason)
        return False

    def _static_state(self) -> Dict[str, Tensor]:
        """The static buffers of the tensor states, holding the current state.

        A state tensor that is not its buffer (a fresh metric, or one whose state ``reset``,
        ``load_state_dict`` or an eager step replaced) is copied into it and replaced by it.
        """
        cache, tensors = self._graphs, self._state.tensors
        slab = cache.state
        if slab is None:
            slab = cache.state = {k: torch.empty_like(v, memory_format=torch.contiguous_format) for k, v in tensors.items()}
        for name, buf in slab.items():
            current = tensors[name]
            if current is not buf:
                if current.shape != buf.shape or current.dtype != buf.dtype:  # the graphs read the old buffers
                    self._graphs = _dispatch.GraphCache()
                    return self._static_state()
                buf.copy_(current)
                tensors[name] = buf
        return slab

    def _run_graph(self, op: str, extra: Any, args: tuple, kwargs: dict, build: Callable, *, counted: bool = False) -> Any:
        """One step of the graph tier over this metric's static state; ``_MISS`` if it ran no graph.

        The step is keyed on ``(op, extra)`` and the input signature. ``build(slab, count,
        static_args, static_kwargs)`` returns the step's ``fn``, giving its values and the new
        state, which the commit writes into the static buffers. ``counted`` steps read the update
        count from a device scalar that the graph itself advances, so a replay never bakes in a
        host value.
        """
        try:
            key = (op, extra, _dispatch.signature(args, kwargs))
        except TypeError:
            _dispatch.STATS.note_fallback(self, op, "unhashable_argument")
            return _MISS
        cache = self._graphs
        slab = self._static_state()
        count = None
        if counted:
            if cache.count is None:
                cache.count = torch.zeros((), dtype=torch.float32, device=self._device)
            if cache.count_value != self._update_count:
                cache.count.fill_(float(self._update_count))
            count = cache.count

        def build_step(s_args: tuple, s_kwargs: dict):
            fn = build(slab, count, s_args, s_kwargs)

            def commit(new_state: Dict[str, Tensor]) -> None:
                for name, value in new_state.items():
                    if value is not slab[name]:
                        slab[name].copy_(value)
                if count is not None:
                    count.add_(1)

            return fn, commit

        state = self._state
        state.inflight = True
        try:
            values = cache.run(self, op, key, self._device, args, kwargs, build_step)
        except _dispatch.ReplayError:
            # the replay died with the static buffers part-written: nothing of them can be trusted
            self._recover_failed_step(op)
            return _MISS
        finally:
            state.inflight = False
        if values is _MISS:
            return _MISS
        state.generation += 1
        if counted:
            cache.count_value = self._update_count + 1
        return values

    def _recover_failed_step(self, op: str) -> None:
        """After a graph step died mid-flight (JAX ``dispatch.py:273``, ``recover_failed_step``): reset the
        state to the defaults, so the metric stays usable, and say so. The JAX package does this when a
        donated step died after XLA took its buffers; the port's counterpart is a replay that wrote part of
        the static buffers in place. The step's key stays latched broken and runs eagerly from then on."""
        for name in self._state.tensors:
            self._state.tensors[name] = self._defaults[name]
        self._graphs.count_value = None  # the graph may have advanced the device count: refill it
        rank_zero_warn(
            f"A donated {op} dispatch of {type(self).__name__} failed mid-flight;"
            " the metric state was reset to defaults.",
            UserWarning,
        )

    def _graph_compute(self, key: Any, fn: Callable, args: tuple, op: str = "compute") -> Any:
        """``fn(*args)``, a computation that reads no state, as one captured graph per ``key`` and
        input signature on the graph tier (values copied out, as a forward's are), else eagerly.
        The retrieval computes run through it, as the JAX package jits them (``retrieval/base.py:447``);
        ``op`` names the step kind its captures count under."""
        if self._graph_gate(op, reads_state=False):

            def build(s_args: tuple, s_kwargs: dict):
                return (lambda: (fn(*s_args), {})), (lambda new_state: None)

            values = self._graphs.run(self, op, (key, _dispatch.signature(args, {})), self._device, args, {},
                                      build)
            if values is not _MISS:
                return values
        return fn(*args)

    def _update_eager(self, args: tuple, kwargs: dict) -> None:
        out = self._effective_update()(dict(self._state.tensors), *args, **kwargs)
        for name in self._state.tensors:
            if name in out:
                self._state.tensors[name] = out[name]
        self._append(out)

    def _graph_update(self, args: tuple, kwargs: dict) -> Any:
        """The ``fast_update`` tier: one graph per input signature whose output is the new state
        (reference ``_build_aot_update``, ``metric.py:673``)."""
        upd = self._effective_update()

        def build(slab, count, s_args, s_kwargs):
            def fn():
                out = upd(dict(slab), *s_args, **s_kwargs)
                return None, {k: out.get(k, v) for k, v in slab.items()}
            return fn

        return self._run_graph("update", (), args, kwargs, build)

    def _guard_synced(self, op: str) -> None:
        """Refuse to change a synced state (JAX ``metric.py:497``, ``:545``, ``:810``)."""
        if self._is_synced:
            if op == "forward":
                raise TorchMetricsUserError("The Metric shouldn't be synced when performing `forward`.")
            raise TorchMetricsUserError("The Metric has already been synced. HINT: Did you forget to call `unsync`?")

    def _quiesce(self) -> None:
        """Drain the async ingestion window before a host access (JAX ``metric.py:272-1876``): a no-op
        without an engine, and from the drain thread itself."""
        eng = self._serve
        if eng is not None:
            eng.quiesce()

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Accumulate a batch into the metric state (reference ``metric.py:495``)."""
        self._guard_synced("update")
        _dispatch.guard_buffered_pending(self, "update")
        self._quiesce()  # FIFO against the async batches; a no-op from the drain thread
        obs.bump(self, "update_calls")
        with obs.metric_span(self, "update"):
            args, kwargs = self._coerce(args, kwargs)
            if self._should_validate():
                self._validate(*args, **kwargs)
            obs.count_dispatch(self)
            if not (self._graph_gate("update", fast_update=True) and self._graph_update(args, kwargs) is not _MISS):
                self._update_eager(args, kwargs)
        self._bump()
        self._note_sketch(args, kwargs)

    def _note_sketch(self, args: tuple, kwargs: dict) -> None:
        """The sketch counters of one update (JAX ``metric.py:526-532``): one dict miss for a
        metric without sketch states."""
        if self.__dict__.get("_sketch_specs"):
            from torchmetrics_tpu_torch.sketch import state as _sketch_state

            _sketch_state.note_update(self, args, kwargs)

    def update_batches(self, *args: Any, **kwargs: Any) -> None:
        """Fold a whole stack of batches into the state (reference ``metric.py:534``).

        The arguments carry a leading axis of ``n_batches`` over those of :meth:`update`. On the
        card the stack is one graph replay (one per stack signature). Validation, where on, reads
        the stack back to the host once and checks each batch there. List states and
        ``scan_update=False`` take a loop of :meth:`update` calls.
        """
        self._guard_synced("update_batches")
        _dispatch.guard_buffered_pending(self, "update_batches")
        self._quiesce()
        obs.bump(self, "update_batches_calls")
        args, kwargs = self._coerce(args, kwargs)
        n_batches = int((args[0] if args else next(iter(kwargs.values()))).shape[0])
        if self._state.lists or not self.scan_update:
            reason = "list_state" if self._state.lists else "scan_update_off"
            _dispatch.STATS.note_fallback(self, "update_batches", reason)
            for i in range(n_batches):
                self.update(*(a[i] for a in args), **{k: v[i] for k, v in kwargs.items()})
            return
        if self._should_validate():
            host_args = tuple(a.cpu() if isinstance(a, Tensor) else a for a in args)
            host_kwargs = {k: v.cpu() if isinstance(v, Tensor) else v for k, v in kwargs.items()}
            for i in range(n_batches):
                self._validate(*(a[i] for a in host_args), **{k: v[i] for k, v in host_kwargs.items()})
        obs.count_dispatch(self)
        with obs.metric_span(self, "update_batches"):
            if not (self._graph_gate("update_batches") and self._graph_update_batches(args, kwargs) is not _MISS):
                folded = _fold(self._effective_update(), dict(self._state.tensors), args, kwargs)
                self._state.tensors.update(folded)
        self._bump(n_batches)
        self._note_sketch(args, kwargs)

    def _graph_update_batches(self, args: tuple, kwargs: dict) -> Any:
        upd = self._effective_update()

        def build(slab, count, s_args, s_kwargs):
            return lambda: (None, _fold(upd, dict(slab), s_args, s_kwargs))

        return self._run_graph("update_batches", (), args, kwargs, build)

    def _fusable_forward(self) -> bool:
        """The whole reduce-state forward can be one graph: capturable update and compute, tensor
        states only, and shape-stable reductions, named or a callable declared ``traceable`` (the
        KLL merge), as the JAX package's ``_fusable_forward`` takes them (reference ``metric.py:881``)."""
        return (
            self.jit_update
            and self.jit_compute
            and not self._state.lists
            and all(self._reductions[n] in _FUSABLE_REDUCTIONS or getattr(self._reductions[n], "traceable", False)
                    for n in self._state.tensors)
        )

    def _count_tensor(self) -> Optional[Tensor]:
        """The update count as a float32 device scalar, for the eager tier's ``mean`` merges."""
        if "mean" not in (self._reductions[n] for n in self._state.tensors):
            return None
        return torch.full((), float(self._update_count), dtype=torch.float32, device=self._device)

    def _forward_step(self, args: tuple, kwargs: dict, computes: Sequence[Callable]) -> List[Any]:
        """One reduce-state forward step on the eager tier (``metric.py:1247-1297``): update a
        default state with the batch, evaluate each of ``computes`` on that batch state, then
        merge it into the global state. Compute groups pass every member's ``_compute``."""
        batch_out = self._effective_update()(self._default_state(), *args, **kwargs)
        batch_state: Dict[str, Any] = {n: batch_out.get(n, self._defaults[n]) for n in self._state.tensors}
        for name in self._state.lists:
            entry = batch_out.get(name)
            if entry is None:
                batch_state[name] = []
            else:
                batch_state[name] = dim_zero_cat(list(entry) if isinstance(entry, (list, tuple)) else [entry])
        values = [self._squeeze_if_scalar(compute(batch_state)) for compute in computes]
        self._bump()
        merged = _merge_tensor_ladder(self._state.tensors, batch_out, self._defaults, self._reductions,
                                      self._count_tensor())
        self._state.tensors.update(merged)
        self._append(batch_out)
        return values

    def _graph_forward(self, args: tuple, kwargs: dict, computes: Sequence[Callable], members: tuple) -> Any:
        """The fused forward step as one graph: the update on the defaults, every compute in
        ``computes`` on that batch state, and the merge (reference ``_build_aot_forward``,
        ``metric.py:1020``; ``_build_aot_group_forward``, ``collections.py:185``)."""
        upd, squeeze = self._effective_update(), self._squeeze_if_scalar
        defaults = self._default_state()
        reductions = {k: self._reductions[k] for k in defaults}

        def build(slab, count, s_args, s_kwargs):
            def fn():
                batch_out = upd(dict(defaults), *s_args, **s_kwargs)
                batch_state = {k: batch_out.get(k, v) for k, v in defaults.items()}
                values = [squeeze(compute(batch_state)) for compute in computes]
                n = None if count is None else count + 1
                merged = _merge_tensor_ladder(dict(slab), batch_out, defaults, reductions, n)
                return values, merged
            return fn

        counted = "mean" in reductions.values()
        # a compute group's step is its own kind of capture, as the JAX package's ``group_forward``
        op = "group_forward" if members else "forward"
        values = self._run_graph(op, members, args, kwargs, build, counted=counted)
        if values is not _MISS:
            self._bump()
        return values

    def _fused_forward(self, args: tuple, kwargs: dict, computes: Sequence[Callable], members: tuple) -> List[Any]:
        """A validated batch through the reduce-state forward: on a graph where the gate allows,
        else eagerly. One device step when fusable, two otherwise (update and batch compute), as
        the JAX package counts them."""
        if self._fusable_forward():
            obs.count_dispatch(self)
            values = _MISS
            if self._graph_gate("forward"):
                values = self._graph_forward(args, kwargs, computes, members)
            if values is _MISS:
                values = self._forward_step(args, kwargs, computes)
            self._note_sketch(args, kwargs)
            return values
        _dispatch.STATS.note_fallback(self, "forward", "not_fusable")
        obs.count_dispatch(self, 2)
        return self._forward_step(args, kwargs, computes)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate the batch AND return its batch-local value (reference ``metric.py:804``).
        With ``dist_sync_on_step`` the batch value is synced across the world, on the eager path of
        the ``full_state_update`` forward, never inside a graph."""
        self._guard_synced("forward")
        _dispatch.guard_buffered_pending(self, "forward")
        self._quiesce()
        obs.bump(self, "forward_calls")
        with obs.metric_span(self, "forward"):
            if self.full_state_update or self.dist_sync_on_step:
                return self._forward_full_state_update(*args, **kwargs)
            args, kwargs = self._coerce(args, kwargs)
            if self._should_validate():
                self._validate(*args, **kwargs)
            return self._fused_forward(args, kwargs, [self._compute], ())[0]

    def _forward_full_state_update(self, *args: Any, **kwargs: Any) -> Any:
        """Reference ``metric.py:831``: update the global state, then compute on the batch alone.

        For a metric with tensor states and a capturable update and compute, and no
        ``dist_sync_on_step``, the batch value is ``compute(update(defaults, batch))``; otherwise
        the state is reset, updated with the batch, computed (synced when ``dist_sync_on_step``)
        and restored (JAX ``metric.py:860-877``).
        """
        args, kwargs = self._coerce(args, kwargs)
        self.update(*args, **kwargs)
        if not self.dist_sync_on_step and self.jit_update and self.jit_compute and not self._state.lists:
            obs.count_dispatch(self)
            batch_out = self._effective_update()(self._default_state(), *args, **kwargs)
            batch_state = {k: batch_out.get(k, v) for k, v in self._default_state().items()}
            return self._squeeze_if_scalar(self._compute(batch_state))
        obs.bump(self, "full_state_slow_path_calls")
        obs.telemetry.counter("engine.full_state_forward.extra_dispatches").inc(2)
        count = self._update_count
        tensors, lists = dict(self._state.tensors), {k: list(v) for k, v in self._state.lists.items()}
        self._to_sync = self.dist_sync_on_step
        self._should_unsync = False
        self.reset()
        try:
            self.update(*args, **kwargs)
            batch_value = self.compute()
        finally:
            # restore the global state even when the batch-local compute raises
            self._state.tensors.update(tensors)
            self._state.lists.update(lists)
            self._update_count = count
            self._is_synced = False
            self._cache = None
            self._should_unsync = True
            self._to_sync = self.sync_on_compute
            self._computed = None
            self._update_called = True
        return batch_value

    def buffered(self, k: int, journal: Optional[Any] = None) -> "_dispatch.BufferedUpdater":
        """Deferred accumulator (reference ``metric.py:1114``): up to ``k`` ``update`` batches kept
        on the host, then folded by one :meth:`update_batches` call. While batches are pending,
        ``update``, ``forward``, ``compute`` and ``metric_state`` raise. As a context manager it
        flushes on a clean exit::

            with metric.buffered(32) as buf:
                for preds, target in loader:
                    buf.update(preds, target)
            value = metric.compute()

        ``journal`` (a :class:`~torchmetrics_tpu_torch.robust.journal.Journal`) is appended each batch at
        ``update`` time, before it is pending, so a preemption with batches pending loses none of them.
        """
        return _dispatch.BufferedUpdater(self, k, journal=journal)

    def journal(self, path: Any, every_k: int = 64, resume: bool = False) -> Any:
        """Write-ahead journaled proxy (JAX ``metric.py:1131``): every batch is durable on disk before it is
        applied, and a durable snapshot is taken (and the journal truncated) every ``every_k`` appends.
        ``resume=True`` first restores ``snapshot + replay(journal)`` from ``path``. Returns a
        :class:`~torchmetrics_tpu_torch.robust.journal.MetricJournal`."""
        from torchmetrics_tpu_torch.robust import journal as _journal

        return _journal.MetricJournal(self, path, every_k=every_k, resume=resume)

    # ------------------------------------------------------------- async ingestion
    def serve(self, options: Optional[Any] = None, journal: Optional[Any] = None,
              control: Optional[Any] = None) -> Any:
        """Configure (or fetch) this metric's async ingestion engine (JAX ``metric.py:1178``).

        Idempotent: the first call builds the :class:`~torchmetrics_tpu_torch.serve.engine.IngestEngine` from
        ``options`` (default: the ``TM_TPU_SERVE_*`` env knobs) with an optional write-ahead ``journal`` (a
        :class:`~torchmetrics_tpu_torch.robust.journal.Journal`, appended at ENQUEUE time, so a preemption
        mid-overlap recovers via ``snapshot + replay``); later calls return the existing engine.
        Reconfiguring a live engine with different options is an error. ``control`` attaches a
        :class:`~torchmetrics_tpu_torch.serve.control.ServeController`; ``True`` builds one with the default
        ``ControlOptions``.
        """
        from torchmetrics_tpu_torch.serve import IngestEngine, ServeController, serve_options_from_env

        eng = self.__dict__.get("_serve")
        if eng is None:
            eng = IngestEngine(self, options or serve_options_from_env(), journal=journal)
            self._serve = eng
            obs.telemetry.counter("serve.engines").inc()
            if control is not None and control is not False:
                (ServeController() if control is True else control).attach(eng)
            return eng
        if options is not None and options != eng.options:
            raise TorchMetricsUserError(
                "This metric's ingestion engine is already configured with"
                f" {eng.options}; serve() cannot re-configure it to {options}."
            )
        if journal is not None and eng.journal is None:
            eng.journal = journal
        if control is not None and control is not False and eng._control is None:
            (ServeController() if control is True else control).attach(eng)
        return eng

    def update_async(self, *args: Any, **kwargs: Any) -> Any:
        """Non-blocking :meth:`update` (JAX ``metric.py:1222``): enqueue the batch, return an ``IngestTicket``.

        The batch stages through pinned host buffers and a copy stream, so the transfer overlaps the previous
        step, and a background drain applies it through the ordinary dispatch tiers in FIFO order. The
        in-flight window is bounded (``ServeOptions(max_inflight=..., on_full="block"|"raise"|"shed")``):
        backpressure, never OOM. ``compute``/``snapshot``/``sync``/``reset`` and any synchronous
        ``update``/``forward`` quiesce the window first. Validation, where on, runs on the caller, over host
        arrays on the host.
        """
        self._guard_synced("update_async")
        # the buffered-pending guard fires BEFORE the enqueue: a buffered window and an async window must not
        # interleave
        _dispatch.guard_buffered_pending(self, "update_async")
        eng = self.__dict__.get("_serve")
        if eng is None:
            eng = self.serve()
        if self._should_validate():
            h_args, h_kwargs = _host_view(args, kwargs)
            self._validate(*h_args, **h_kwargs)  # fail fast on the caller, not in the drain
        return eng.enqueue(args, kwargs)

    def dump_diagnostics(self, reason: str = "manual", directory: Optional[Any] = None) -> Optional[str]:
        """Capture a post-mortem flight bundle for THIS metric, on demand (JAX ``metric.py:1609``).

        The bundle carries the flight ring, the telemetry snapshot, this metric's state shapes and last sync
        summary, the write-ahead journal cursor (when serving with a WAL) and an env fingerprint; read it
        with ``python -m torchmetrics_tpu_torch.obs.bundle inspect|validate|diff``. Returns the written path,
        or None when bundling is disabled (``TM_TPU_BUNDLES=0``) or capture failed (warned, never raised).
        """
        return obs.capture_bundle(reason, metric=self, directory=directory)

    def snapshot(self) -> Dict[str, Any]:
        """Durable, versioned, CRC-checksummed host-side blob of every state (JAX ``metric.py:1590``), the
        update count and the state generation; the JAX package's format. Raises
        :class:`~torchmetrics_tpu_torch.utils.exceptions.SnapshotError` while a graph step writes the state
        or with buffered batches pending."""
        from torchmetrics_tpu_torch.robust import checkpoint as _checkpoint

        return _checkpoint.snapshot_metric(self)

    def restore(self, blob: Dict[str, Any]) -> None:
        """Restore the state from a :meth:`snapshot` blob (this package's or the JAX package's), after
        validating its format, version, CRC, names, shapes and dtypes (JAX ``metric.py:1600``)."""
        from torchmetrics_tpu_torch.robust import checkpoint as _checkpoint

        _checkpoint.restore_metric(self, blob)

    def plot(self, val: Any = None, ax: Any = None) -> Any:
        """Plot the (or a provided) metric value (JAX ``metric.py:1931``, reference ``metric.py:636-670``)."""
        from torchmetrics_tpu_torch.utils.plot import plot_single_or_multi_val

        val = val if val is not None else self.compute()
        return plot_single_or_multi_val(
            val, ax=ax, higher_is_better=self.higher_is_better, name=type(self).__name__,
            lower_bound=self.plot_lower_bound, upper_bound=self.plot_upper_bound,
            legend_name=self.plot_legend_name,
        )

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def windowed(self, window: int, advance_every: Optional[int] = None, **kwargs: Any) -> Any:
        """Sliding-window twin of this metric (JAX ``metric.py:1151``): a
        :class:`~torchmetrics_tpu_torch.online.Windowed` with this instance as its template (never
        updated itself), rotating every ``advance_every`` updates."""
        from torchmetrics_tpu_torch.online import Windowed

        return Windowed(self, window=window, advance_every=advance_every, **kwargs)

    def ema(self, decay: float = 0.99, **kwargs: Any) -> Any:
        """Exponentially decayed twin of this metric (JAX ``metric.py:1168``; sum-reduced states
        only): a :class:`~torchmetrics_tpu_torch.online.Ema`."""
        from torchmetrics_tpu_torch.online import Ema

        return Ema(self, decay=decay, **kwargs)

    # ----------------------------------------------------------------- compute
    @staticmethod
    def _squeeze_if_scalar(value: Any) -> Any:
        if isinstance(value, Tensor) and value.shape == (1,):
            return value.squeeze()
        return value

    def _own(self, value: Any) -> Any:
        """``value`` with a copy of each tensor that shares a state tensor's storage."""
        storages = {v.untyped_storage().data_ptr() for v in self._state.tensors.values()}

        def own(x: Any) -> Any:
            if isinstance(x, Tensor) and x.untyped_storage().data_ptr() in storages:
                return x.clone()
            return x

        return tree_map(own, value)

    # -------------------------------------------------------------------- sync
    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        """Gather and reduce every state across the world (JAX ``metric.py:1310``): the state's
        dict entries are replaced by the synced tensors; the local ones stay in ``_cache``."""
        obs.bump(self, "sync_calls")
        state = {**self._state.tensors, **{k: list(v) for k, v in self._state.lists.items()}}
        opts = self.sync_options if self.sync_options is not None else sync_options_from_env()
        with obs.metric_span(self, "sync"):
            synced = process_sync(state, self._reductions, gather_fn=dist_sync_fn, group=process_group,
                                  options=opts, device=self._device)
        # the grade is the latest sync's, never a sticky earlier one
        self._world_consistent = as_consistency(synced.world_consistent)
        self._tm_last_sync = {
            "world_consistent": str(self._world_consistent),
            "degraded_states": tuple(synced.degraded_states),
            "quorum_states": tuple(synced.quorum_states),
            "responding_ranks": dict(synced.responding_ranks),
            "readmitted_ranks": tuple(synced.readmitted_ranks),
            "gather_latency_us": dict(synced.gather_latency_us),
            "bytes_shipped": synced.bytes_shipped,
            "bytes_received": synced.bytes_received,
            "bytes_saved": synced.bytes_saved,
            "sharded_states": tuple(synced.sharded_states),
            "compression": synced.compression,
            "compressed_states": tuple(synced.compressed_states),
        }
        for name in list(self._state.tensors):
            self._state.tensors[name] = synced[name]
        for name in list(self._state.lists):
            v = synced[name]
            self._state.lists[name] = list(v) if isinstance(v, (list, tuple)) else [v]

    def sync(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        distributed_available: Optional[Callable] = None,
    ) -> None:
        """Keep the local state and replace it with the world's synced state (JAX ``metric.py:1383``,
        reference ``metric.py:489``). It does nothing when ``should_sync`` is False, or when there
        is nothing to sync against: no ``dist_sync_fn`` and no distributed world."""
        if self._is_synced and should_sync:
            raise TorchMetricsUserError("The Metric has already been synced.")
        _dispatch.guard_buffered_pending(self, "sync")
        self._quiesce()  # the gathered state must include every async batch
        self._state.guard_readable()
        if distributed_available is None and self.distributed_available_fn is not None:
            distributed_available = self.distributed_available_fn
        is_distributed = distributed_available() if callable(distributed_available) else False
        dist_sync_fn = dist_sync_fn or self.dist_sync_fn
        if not should_sync or (dist_sync_fn is None and not is_distributed):
            return
        self._cache = {"tensors": dict(self._state.tensors), "lists": {k: list(v) for k, v in self._state.lists.items()}}
        self._sync_dist(dist_sync_fn, process_group=process_group or self.process_group)
        self._is_synced = True

    def unsync(self, should_unsync: bool = True) -> None:
        """Put the local state back (JAX ``metric.py:1407``, reference ``metric.py:533-553``): the
        same tensor objects, which on the graph tier are the static buffers its graphs write."""
        if not should_unsync:
            return
        if not self._is_synced:
            raise TorchMetricsUserError("The Metric has already been un-synced.")
        if self._cache is None:
            raise TorchMetricsUserError("The internal cache should exist to unsync the Metric.")
        self._quiesce()  # batches enqueued while synced would land mid-restore otherwise
        self._state.tensors.update(self._cache["tensors"])
        self._state.lists.update(self._cache["lists"])
        self._is_synced = False
        self._cache = None

    @contextmanager
    def sync_context(
        self,
        dist_sync_fn: Optional[Callable] = None,
        process_group: Optional[Any] = None,
        should_sync: bool = True,
        should_unsync: bool = True,
        distributed_available: Optional[Callable] = None,
    ) -> Generator[None, None, None]:
        """``sync()`` on entry, ``unsync()`` on exit (JAX ``metric.py:1423``, reference ``metric.py:555-590``)."""
        self.sync(dist_sync_fn=dist_sync_fn, process_group=process_group, should_sync=should_sync,
                  distributed_available=distributed_available)
        yield
        self.unsync(should_unsync=self._is_synced and should_unsync)

    def compute(self) -> Any:
        """Finalise the accumulated state to the metric value (reference ``metric.py:1468``).

        The state is synced across the world for the compute and put back after it (JAX
        ``metric.py:1485-1489``). With ``compute_with_cache`` (the default) the value is cached
        until the next ``update``, ``forward`` or ``reset``.
        """
        _dispatch.guard_buffered_pending(self, "compute")
        self._quiesce()  # a quiesced compute is exact over every enqueued batch
        self._state.guard_readable()
        if not self._update_called:
            rank_zero_warn(
                f"The ``compute`` method of metric {type(self).__name__} was called before the ``update`` method"
                " which may lead to errors, as metric states have not yet been updated.",
                UserWarning,
            )
        obs.bump(self, "compute_calls")
        if self.compute_with_cache and self._computed is not None:
            return self._computed
        self._guard_poison()
        obs.count_dispatch(self)
        with obs.metric_span(self, "compute"), self.sync_context(
                dist_sync_fn=self.dist_sync_fn, should_sync=self._to_sync, should_unsync=self._should_unsync):
            value = self._own(self._squeeze_if_scalar(self._compute(self._computable_state())))
        if self.compute_with_cache:
            self._computed = value
        return value

    def _computable_state(self) -> Dict[str, Any]:
        """The state as ``_compute`` takes it: list states concatenated (``[]`` when empty)."""
        state: Dict[str, Any] = dict(self._state.tensors)
        for name, entries in self._state.lists.items():
            state[name] = dim_zero_cat(entries) if entries else []
        return state

    def reset(self) -> None:
        """Restore the default state (reference ``metric.py:1500``). The states are replaced by
        their defaults; a later graph step copies them into its static buffers. A kept local state
        (``sync`` without ``unsync``) is dropped, and the sync grade goes back to ``full``. With async batches in
        flight the window is quiesced first: every batch enqueued before ``reset`` commits, then the state
        clears."""
        self._quiesce()
        self._update_count = 0
        self._update_called = False
        self._computed = None
        self._cache = None
        self._is_synced = False
        self._world_consistent = FULL
        for name in self._state.tensors:
            self._state.tensors[name] = self._defaults[name]
        for name in self._state.lists:
            self._state.lists[name] = []

    # ------------------------------------------------------------- persistence
    def _as_state(self, name: str, value: Any, list_dtype: Optional[torch.dtype] = None) -> Tensor:
        """``value`` as a state tensor on this metric's device, in the dtype of the state's default
        (``list_dtype`` for the entries of a list state, or their own). Float values bound for an
        integer state must be whole numbers: counts carried as float32 (the JAX package's) convert
        exactly, anything else raises."""
        default = self._defaults[name]
        dtype = default.dtype if isinstance(default, Tensor) else list_dtype
        tensor = value if isinstance(value, Tensor) else torch.from_numpy(np.array(value))
        if dtype is not None and not dtype.is_floating_point and tensor.is_floating_point():
            if not bool(torch.all(tensor == torch.round(tensor))):
                raise ValueError(f"{type(self).__name__} state {name!r} holds counts, but the values given are not whole")
        return tensor.to(device=self._device, dtype=dtype)

    def _set_states(self, values: Dict[str, Any]) -> None:
        """Replace the named states; a list state takes a sequence of entries. A replaced tensor
        state is copied into the static buffers by the next graph step."""
        for name, value in values.items():
            if name in self._state.lists:
                self._state.lists[name] = [self._as_state(name, e) for e in value]
            elif name in self._state.tensors:
                self._state.tensors[name] = self._as_state(name, value)
            else:
                raise KeyError(f"{type(self).__name__} has no state {name!r}; its states are {sorted(self._defaults)}")
        if values:
            self._update_called = True
            self._computed = None

    def persistent(self, mode: bool = False) -> None:
        """Set whether every state goes into :meth:`state_dict` (JAX ``metric.py:1701``, reference
        ``metric.py:826``); ``add_state`` registers states as not persistent."""
        for name in self._persistent:
            self._persistent[name] = mode

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "", keep_vars: bool = False) -> dict:
        """Checkpoint dict of the persistent states (reference ``metric.py:1706``), copies unless
        ``keep_vars``.

        Beyond the reference format it holds ``_update_count``, which mean reductions need.
        """
        self._quiesce()  # the checkpoint must include every async batch
        destination = destination if destination is not None else {}
        for name, persistent in self._persistent.items():
            if not persistent:
                continue
            if name in self._state.tensors:
                v = self._state.tensors[name]
                destination[prefix + name] = v if keep_vars else v.detach().clone()
            else:
                destination[prefix + name] = [e if keep_vars else e.detach().clone() for e in self._state.lists[name]]
        if any(self._persistent.values()):
            destination[prefix + "_update_count"] = self._update_count
        return destination

    def load_state_dict(self, state_dict: dict, strict: bool = True, prefix: str = "") -> None:
        """Restore the persistent states from a checkpoint dict (reference ``metric.py:1727``)."""
        self._quiesce()  # in-flight batches must not interleave with a restore
        restored_count = state_dict.get(prefix + "_update_count")
        values = {}
        for name, persistent in self._persistent.items():
            if prefix + name in state_dict:
                values[name] = state_dict[prefix + name]
            elif strict and persistent:
                raise RuntimeError(f"Missing key {name!r} in state_dict")
        self._set_states(values)
        if values:
            self._update_count = int(restored_count) if restored_count is not None else max(self._update_count, 1)
            self._update_called = self._update_count > 0

    def to(self, device: Union[str, torch.device]) -> "Metric":
        """Move every state and default to ``device`` (reference ``_apply``, ``metric.py:776-824``);
        the captured graphs, which read the old addresses, are dropped."""
        self._quiesce()  # device moves must not race the drain's commits
        dev = resolve_device(device)
        state = self._state
        state.tensors = {k: v.to(dev) for k, v in state.tensors.items()}
        state.lists = {k: [e.to(dev) for e in v] for k, v in state.lists.items()}
        self._defaults = {k: v.to(dev) if isinstance(v, Tensor) else v for k, v in self._defaults.items()}
        if isinstance(self._computed, Tensor):
            self._computed = self._computed.to(dev)
        self._device = dev
        self._graphs = _dispatch.GraphCache()
        return self

    def set_dtype(self, dst_type: torch.dtype) -> "Metric":
        """Cast the float states, their defaults and the entries of float list states to ``dst_type``
        (reference ``metric.py:740-774``, JAX ``metric.py:1873``). The captured graphs, the static
        state buffers and the mean-count scalar are dropped, as ``to()`` drops them: the graphs read
        buffers of the old dtype, so the next graph step captures anew."""

        def cast(v: Tensor) -> Tensor:
            return v.to(dst_type) if v.is_floating_point() else v

        self._quiesce()
        state = self._state
        state.tensors = {k: cast(v) for k, v in state.tensors.items()}
        state.lists = {k: [cast(e) for e in v] for k, v in state.lists.items()}
        self._defaults = {k: cast(v) if isinstance(v, Tensor) else v for k, v in self._defaults.items()}
        self._dtype = dst_type
        self._graphs = _dispatch.GraphCache()
        return self

    def float(self) -> "Metric":
        """A no-op, as in the JAX package and the reference: cast with :meth:`set_dtype`."""
        return self

    def double(self) -> "Metric":
        """A no-op, as in the JAX package and the reference: cast with :meth:`set_dtype`."""
        return self

    def half(self) -> "Metric":
        """A no-op, as in the JAX package and the reference: cast with :meth:`set_dtype`."""
        return self

    def clone(self) -> "Metric":
        """Deep copy (reference ``metric.py:1629``), with no captured graph of its own yet."""
        return deepcopy(self)

    def __deepcopy__(self, memo: dict) -> "Metric":
        self._quiesce()  # the copy must capture every enqueued batch
        cls = self.__class__
        new = cls.__new__(cls)
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            if k == "_graphs":  # a graph's static buffers belong to the original: the copy captures its own
                new.__dict__[k] = _dispatch.GraphCache()
            elif k == "_serve":  # a live thread bound to THIS instance's state: clones start unconfigured
                new.__dict__[k] = None
            elif k == "process_group":  # a process group is a handle to the world, shared, never copied
                new.__dict__[k] = v
            else:
                new.__dict__[k] = deepcopy(v, memo)
        return new

    def __getstate__(self) -> Dict[str, Any]:
        """Pickle everything but the captured graphs and the ingestion engine (reference ``metric.py:1657``):
        threads do not pickle, so the receiving process opts in to serving again."""
        self._quiesce()  # pickle an exact state, not a mid-window one
        return {k: v for k, v in self.__dict__.items() if k not in ("_graphs", "_serve")}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._graphs = _dispatch.GraphCache()

    # ----------------------------------------------------------------- helpers
    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep only the kwargs this metric's ``_update`` accepts (reference ``metric.py:1904``)."""
        if not kwargs:
            return kwargs
        params = inspect.signature(self._update).parameters
        if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
            return kwargs
        return {k: v for k, v in kwargs.items() if k in params and k != "state"}

    def __repr__(self) -> str:
        return f"{type(self).__name__}(device={self._device})"

    # ---------------------------------------------------------- composition ops
    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, other, self)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, self, other)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, other, self)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, self, other)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, other, self)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, self, other)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, other, self)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, other, self)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        # fmod (truncation toward zero), as the reference's torch.fmod and the JAX package's jnp.fmod
        return CompositionalMetric(torch.fmod, self, other)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.fmod, other, self)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, self, other)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, other, self)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, self, other)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, other, self)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, self, other)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, other, self)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, self, other)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, other, self)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, self, other)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, other, self)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.eq, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.ne, self, other)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.lt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.le, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.gt, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.ge, self, other)

    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(_neg, self, None)

    def __pos__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __inv__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_not, self, None)

    __invert__ = __inv__

    def __getitem__(self, idx) -> "CompositionalMetric":
        return CompositionalMetric(lambda x: x[idx], self, None)


def _host_view(args: tuple, kwargs: dict) -> tuple:
    """A batch as ``_validate`` takes it, without a device round trip: each numeric numpy array as a CPU
    tensor over its memory, everything else as it is."""

    def view(x: Any) -> Any:
        if isinstance(x, np.ndarray) and x.dtype.kind in "biuf":
            return torch.from_numpy(x)
        return x

    return tuple(view(a) for a in args), {k: view(v) for k, v in kwargs.items()}


def _neg(x: Tensor) -> Tensor:
    return -torch.abs(x)


class CompositionalMetric(Metric):
    """Lazy arithmetic over metrics (reference ``metric.py:1078-1201``, JAX ``metric.py:2051``).

    It holds no state of its own: ``update``, ``forward``, ``compute`` and ``reset`` go to the
    operands that are metrics, each given the keyword arguments its own ``update`` takes. An
    operand that is not a metric is a constant tensor on the device of the metric operand.
    """

    full_state_update = True

    def __init__(self, operator: Callable, metric_a: Any, metric_b: Any) -> None:
        device = next(m.device for m in (metric_a, metric_b) if isinstance(m, Metric))
        super().__init__(device=device)
        self.op = operator
        self.metric_a = self._operand(metric_a)
        self.metric_b = self._operand(metric_b)

    def _operand(self, x: Any) -> Any:
        if isinstance(x, Metric) or x is None:
            return x
        return torch.as_tensor(x, device=self._device)

    def update(self, *args: Any, **kwargs: Any) -> None:
        for m in (self.metric_a, self.metric_b):
            if isinstance(m, Metric):
                m.update(*args, **m._filter_kwargs(**kwargs))
        self._bump()

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        val_a, val_b = (m(*args, **m._filter_kwargs(**kwargs)) if isinstance(m, Metric) else m
                        for m in (self.metric_a, self.metric_b))
        self._bump()
        if val_a is None:
            return None
        if val_b is None:
            if isinstance(self.metric_b, Metric):
                return None
            return self.op(val_a)
        return self.op(val_a, val_b)

    def reset(self) -> None:
        for m in (self.metric_a, self.metric_b):
            if isinstance(m, Metric):
                m.reset()
        self._update_called = False
        self._update_count = 0
        self._computed = None

    def persistent(self, mode: bool = False) -> None:
        """Set the persistence of the operands' states (JAX ``metric.py:2112``); the composition holds
        none of its own."""
        for m in (self.metric_a, self.metric_b):
            if isinstance(m, Metric):
                m.persistent(mode=mode)

    def __repr__(self) -> str:
        op = getattr(self.op, "__name__", "op")
        return f"{type(self).__name__}(\n  {op}(\n    {self.metric_a!r},\n    {self.metric_b!r}\n  )\n)"
