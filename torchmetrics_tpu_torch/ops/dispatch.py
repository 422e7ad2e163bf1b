"""Per-step dispatch of the port: captured CUDA graphs, the opt-out gate, deferred accumulation.

Counterpart of ``torchmetrics_tpu/ops/dispatch.py``. The JAX package compiles each fused step
ahead of time, once per abstract input signature, and calls the executable with the state
buffers donated (``FastStepCache``, ``AotEntry``, ``dispatch_step``, ``commit_step``,
``recover_failed_step``: ``:171-310``). The port's counterpart is a captured CUDA graph:

- :class:`GraphCache` holds one :class:`StepGraph` per step kind and input signature (the
  shapes and dtypes of the tensor arguments, and the non-tensor arguments by value), and the
  static buffers that the steps of one metric share: its tensor states and, for ``mean``
  merges, its update count as a device scalar.
- A step is captured once. It is warmed up on a side stream first, which reads the state but
  writes nothing back, so the metric's state does not advance; then captured with
  ``torch.cuda.graph``; then replayed. A step that is captured but not replayed has done no
  work. Each later call copies its batch into the graph's static inputs (one device-to-device
  copy per input tensor: the graph reads fixed addresses) and replays.
- Donation has no counterpart here. A graph reads and writes fixed addresses, so the state
  lives in static buffers that every replay updates in place, where the JAX package hands
  fresh buffers back. So no tensor handed to a caller may be a static buffer: ``metric_state``
  copies, ``compute`` copies a value that shares a state's storage, and a forward's batch
  values are copied out of the graph's outputs, one copy per dtype per step.
- A capture launches nothing. It leaves every kernel's launch counter
  (``ops.bincount.LaunchCounter.ALL``) as it found it, and each replay adds the launches it
  captured. The warm-up's launches are real and counted (``STATS.warmup_launches`` sums them).
- ``STATS`` counts captures, replays and every eager step with the reason it was not a graph,
  as the JAX package notes each dispatch decision.
- Each capture is recorded as a trace of its owner's step kind (``obs.record_trace``): the
  port's counterpart of a jit trace, so a second capture of one kind is a retrace.

The eager tier stays, as in the JAX package: for list states, ``jit_update=False``, exact-mode
curves, the CPU (reason ``cpu_device``) and ``TM_TPU_FAST_DISPATCH=0``, which reads the same
variable as the JAX package, so a user's setting means the same in both. ``EMULATE_ON_CPU`` is a
test seam: with it set, CPU tensors take the graph tier's bookkeeping (static buffers updated in
place, copied outputs, captures and replays counted) and each replay calls the captured body.

:class:`BufferedUpdater` and :func:`guard_buffered_pending` are the JAX package's deferred
accumulation (``:312``, ``:460``): up to ``k`` batches stacked on the host, then folded by one
``update_batches`` call.
"""
from __future__ import annotations

import gc
import os
import threading
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import Tensor
from torch.utils._pytree import tree_flatten, tree_unflatten

from torchmetrics_tpu_torch.obs.telemetry import record_trace
from torchmetrics_tpu_torch.ops.bincount import LaunchCounter
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

ENV_FAST_DISPATCH = "TM_TPU_FAST_DISPATCH"
_FALSY = frozenset(v for base in ("0", "false", "no", "off") for v in (base, base.upper(), base.capitalize()))
#: test seam: run the graph tier's bookkeeping on CPU tensors, calling the body on each replay
EMULATE_ON_CPU = False
#: returned by a tier that did not run the step
MISS = object()
#: ``torch.cuda.graph``'s ``capture_error_mode`` for every capture. ``"thread_local"`` forbids unsafe calls (an
#: allocation, a synchronous copy) in the capturing thread only: the serving tier's drain captures while the
#: caller thread keeps staging, whose first pinned allocation of a slot (``cudaHostAlloc``) the default
#: ``"global"`` mode would refuse, invalidating the drain's capture. The capturing thread is held to the same
#: rules in both modes.
CAPTURE_ERROR_MODE = "thread_local"
#: one capture at a time in the process: ``torch.cuda.graph`` captures on a stream shared by every capture, and
#: the cyclic collector's switch below is process-wide, so a thread that captures (the serving drain) and another
#: that captures at the same moment (a caller folding a time series) must take turns
_CAPTURE_LOCK = threading.Lock()


def fast_dispatch_enabled() -> bool:
    """The graph tier is opt-out: on unless ``TM_TPU_FAST_DISPATCH`` is falsy. One dict lookup."""
    return os.environ.get(ENV_FAST_DISPATCH, "1") not in _FALSY


def graph_device(device: torch.device) -> bool:
    """Whether steps on ``device`` can run as graphs: CUDA, or the CPU under the test seam."""
    return device.type == "cuda" or (EMULATE_ON_CPU and device.type == "cpu")


class DispatchStats:
    """Captures, replays and eager fallbacks (by class, operation and reason), process-wide."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.captures = 0
        self.replays = 0
        #: kernel launches of the warm-ups before each capture (real launches, counted as such)
        self.warmup_launches = 0
        self.fallbacks: Counter = Counter()

    def note_fallback(self, owner: Any, op: str, reason: str) -> None:
        self.fallbacks[(type(owner).__name__, op, reason)] += 1

    @property
    def n_fallbacks(self) -> int:
        return sum(self.fallbacks.values())


STATS = DispatchStats()


class CaptureError(RuntimeError):
    """A step ran eagerly on its warm-up but could not be captured into a graph."""


def signature(args: tuple, kwargs: dict) -> Tuple:
    """Hashable key of one call's inputs: each tensor by shape, dtype and device, anything else
    by type and value. Raises ``TypeError`` for an unhashable non-tensor argument."""

    def leaf(x: Any) -> Tuple:
        if isinstance(x, Tensor):
            return (tuple(x.shape), x.dtype, x.device)
        hash(x)
        return (type(x), x)

    return tuple(leaf(a) for a in args), tuple((k, leaf(kwargs[k])) for k in sorted(kwargs))


def _static_copy(x: Any) -> Any:
    return x.clone(memory_format=torch.contiguous_format) if isinstance(x, Tensor) else x


def _pack(values: Any) -> Tuple[List[Tensor], Any]:
    """The tensor leaves of ``values`` concatenated into one flat tensor per dtype (fresh
    tensors, in the graph's pool under capture), and the layout that :func:`_unpack` reads."""
    leaves, spec = tree_flatten(values)
    groups: Dict[torch.dtype, List[Tensor]] = {}
    layout = []
    for leaf in leaves:
        if isinstance(leaf, Tensor):
            group = groups.setdefault(leaf.dtype, [])
            offset = sum(t.numel() for t in group)
            layout.append((list(groups).index(leaf.dtype), offset, tuple(leaf.shape)))
            group.append(leaf.reshape(-1))
        else:
            layout.append((None, leaf, None))
    return [torch.cat(group) for group in groups.values()], (spec, layout)


def _unpack(flat: List[Tensor], layout: Any) -> Any:
    spec, entries = layout
    leaves = []
    for group, offset, shape in entries:
        if group is None:
            leaves.append(offset)
        elif shape == ():
            leaves.append(flat[group][offset])
        else:
            n = 1
            for d in shape:
                n *= d
            leaves.append(flat[group][offset:offset + n].view(shape))
    return tree_unflatten(leaves, spec)


class StepGraph:
    """One fused step, captured once: its static inputs, its outputs and the launches it holds."""

    __slots__ = ("graph", "body", "args", "kwargs", "packed", "layout", "launches")

    def __init__(self, graph: Optional[torch.cuda.CUDAGraph], body: Callable, args: tuple, kwargs: dict,
                 packed: List[Tensor], layout: Any, launches: List[int]) -> None:
        self.graph, self.body, self.args, self.kwargs = graph, body, args, kwargs
        self.packed, self.layout, self.launches = packed, layout, launches

    def load(self, args: tuple, kwargs: dict) -> None:
        """Copy one call's tensors into the static inputs."""
        for static, x in zip(self.args, args):
            if isinstance(static, Tensor):
                static.copy_(x)
        for name, static in self.kwargs.items():
            if isinstance(static, Tensor):
                static.copy_(kwargs[name])

    def replay(self) -> None:
        if self.graph is None:  # the CPU test seam: run the body in place of the graph
            self.packed, self.layout = self.body(True)
        else:
            self.graph.replay()
            for counter, n in zip(LaunchCounter.ALL, self.launches):
                counter.launches += n
        STATS.replays += 1

    def values(self) -> Any:
        """The last replay's values as tensors of their own: one copy per dtype."""
        if not self.packed:
            return _unpack([], self.layout)
        return _unpack([p.clone() for p in self.packed], self.layout)


def capture(device: torch.device, fn: Callable[[], Tuple[Any, Dict[str, Tensor]]],
            commit: Callable[[Dict[str, Tensor]], None], args: tuple, kwargs: dict) -> StepGraph:
    """Capture ``fn`` (returning ``(values, new_state)``) followed by ``commit(new_state)``.

    ``args``/``kwargs`` are the static inputs ``fn`` reads, already filled. The warm-up runs
    ``fn`` on a side stream without the commit; an error there is the caller's and propagates.
    An error of the capture itself raises :class:`CaptureError`.
    """

    def body(write: bool):
        values, new_state = fn()
        packed, layout = _pack(values)
        if write:
            commit(new_state)
        return packed, layout

    counters = LaunchCounter.ALL
    if device.type != "cuda":
        packed, layout = body(False)
        STATS.captures += 1
        return StepGraph(None, body, args, kwargs, packed, layout, [0] * len(counters))
    with _CAPTURE_LOCK:
        return _capture_on_card(device, body, args, kwargs, counters)


def _capture_on_card(device: torch.device, body: Callable, args: tuple, kwargs: dict, counters: list) -> StepGraph:
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    before = [c.launches for c in counters]
    with torch.cuda.stream(side):
        body(False)  # loads the kernels' libraries and sizes their scratch; writes no state
    current.wait_stream(side)
    STATS.warmup_launches += sum(c.launches - b for c, b in zip(counters, before))
    before = [c.launches for c in counters]
    graph = torch.cuda.CUDAGraph()
    # A metric and its graphs form a reference cycle, freed only by the cyclic collector. A graph
    # destroyed while another is being captured invalidates that capture, so the collector stays
    # off until the capture ends (a full collection first would cost tens of ms per capture).
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode=CAPTURE_ERROR_MODE):
            packed, layout = body(True)
    except Exception as err:
        raise CaptureError(f"{type(err).__name__}: {err}") from err
    finally:
        if collecting:
            gc.enable()
        launches = [c.launches - b for c, b in zip(counters, before)]
        for c, b in zip(counters, before):
            c.launches = b
    STATS.captures += 1
    return StepGraph(graph, body, args, kwargs, packed, layout, launches)


class ReplayError(RuntimeError):
    """A captured step failed while it replayed: the static state buffers it writes may hold part of a step.
    The key is latched broken; the owner decides what its state is worth (``Metric._run_graph`` resets it to
    the defaults, as the JAX package's ``recover_failed_step`` does after a donated step died)."""


class GraphCache:
    """The captured steps of one owner, by key, and the static state buffers they share.

    ``state`` holds the owner's tensor states while its steps run as graphs; ``count`` the
    update count of ``mean`` merges as a float32 device scalar, and ``count_value`` the host
    count it holds (None once it may be stale). ``broken`` latches a key whose capture failed,
    so that it runs eagerly from then on, as the JAX package latches a failed AOT build.
    """

    def __init__(self) -> None:
        self.steps: Dict[Any, StepGraph] = {}
        self.broken: set = set()
        self.state: Optional[Dict[str, Tensor]] = None
        self.count: Optional[Tensor] = None
        self.count_value: Optional[int] = None

    def run(self, owner: Any, op: str, key: Any, device: torch.device, args: tuple, kwargs: dict,
            build: Callable[[tuple, dict], Tuple[Callable, Callable]]) -> Any:
        """Replay the step under ``key``, capturing it first on a miss; ``MISS`` when it runs
        eagerly instead. ``build(static_args, static_kwargs)`` gives the ``(fn, commit)`` pair of
        :func:`capture`."""
        if key in self.broken:
            STATS.note_fallback(owner, op, "capture_failed")
            return MISS
        step = self.steps.get(key)
        if step is None:
            s_args = tuple(_static_copy(a) for a in args)
            s_kwargs = {k: _static_copy(v) for k, v in kwargs.items()}
            fn, commit = build(s_args, s_kwargs)
            try:
                step = capture(device, fn, commit, s_args, s_kwargs)
            except CaptureError as err:
                self.broken.add(key)
                STATS.note_fallback(owner, op, "capture_failed")
                rank_zero_warn(f"{type(owner).__name__}.{op} could not be captured in a CUDA graph and runs"
                               f" eagerly for this input signature: {err}", UserWarning)
                return MISS
            self.steps[key] = step
            record_trace(owner, op, args, kwargs)
        else:
            step.load(args, kwargs)
        try:
            step.replay()
        except Exception as err:
            self.broken.add(key)
            self.steps.pop(key, None)
            STATS.note_fallback(owner, op, "replay_failed")
            raise ReplayError(f"{type(owner).__name__}.{op} failed while its graph replayed: {err!r}") from err
        return step.values()


# ------------------------------------------------------------------ deferred accumulation
def _dtype_name(x: Any) -> str:
    """A leaf's dtype by its numpy name (``float32``), for a tensor as for a numpy array, so that a batch
    keys the same whether it is still on the host or already staged on the device."""
    return str(getattr(x, "dtype", "")).replace("torch.", "")


def _batch_key(args: tuple, kwargs: dict) -> Tuple:
    """Cheap structural key of one buffered (or served) batch: arity, kwarg names, shapes and dtypes.
    The serving engine coalesces consecutive batches of one key (JAX ``dispatch.py:304``)."""
    return (
        tuple((_shape(a), _dtype_name(a)) for a in args),
        tuple(sorted((k, _shape(v), _dtype_name(v)) for k, v in kwargs.items())),
    )


def _shape(x: Any) -> Any:
    shape = getattr(x, "shape", None)
    return None if shape is None else tuple(shape)


class BufferedUpdater:
    """Deferred accumulator: stack up to ``k`` batches on the host, fold them in one call.

    Returned by ``Metric.buffered(k)`` and ``MetricCollection.buffered(k)`` (JAX package
    ``dispatch.py:312``). ``update`` keeps the batch; when ``k`` batches are pending, or on
    :meth:`flush`, :meth:`compute` or a clean context exit, the stack goes through the target's
    ``update_batches`` (one graph replay per compute group on the card). While batches are
    pending, the target's ``update``, ``forward``, ``compute`` and ``metric_state`` raise: its
    state is stale until the flush. A batch of another shape flushes the pending stack first.

    ``journal`` is the robust layer's write-ahead seam (JAX ``dispatch.py:312-366``): any object with an
    ``append(args, kwargs)`` method, canonically
    :class:`torchmetrics_tpu_torch.robust.journal.Journal`. Each batch is journaled durably at ``update``
    time, before it enters the host-side window, so a preemption with batches pending loses nothing:
    recovery replays the journaled stream, the unflushed window included.
    """

    def __init__(self, target: Any, k: int, journal: Optional[Any] = None) -> None:
        if int(k) < 1:
            raise ValueError(f"buffered(k) needs k >= 1, got {k}")
        self._target = target
        self._k = int(k)
        self._journal = journal
        self._pending: List[Tuple[tuple, dict]] = []
        self._pending_key: Optional[Tuple] = None

    def _metrics(self) -> List[Any]:
        values = getattr(self._target, "values", None)
        return list(values()) if callable(values) else [self._target]

    def _set_pending(self, n: int) -> None:
        for m in self._metrics():
            m._buffered_pending = n

    @property
    def pending(self) -> int:
        """Number of batches buffered and not yet flushed."""
        return len(self._pending)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Buffer one batch; flushes when ``k`` batches are pending."""
        if self._journal is not None:
            # write-ahead: the batch is durable before it is merely pending in memory
            self._journal.append(args, kwargs)
        key = _batch_key(args, kwargs)
        if self._pending and key != self._pending_key:
            self.flush()  # stacking needs one shape: fold the pending window first
        self._pending_key = key
        self._pending.append((args, kwargs))
        self._set_pending(len(self._pending))
        if len(self._pending) >= self._k:
            self.flush()

    def flush(self) -> None:
        """Fold every pending batch into the target's state with one ``update_batches`` call."""
        if not self._pending:
            return
        batches = self._pending
        self._pending = []
        self._pending_key = None
        self._set_pending(0)
        if len(batches) == 1:
            args, kwargs = batches[0]
            self._target.update(*args, **kwargs)
            return
        first_args, first_kwargs = batches[0]
        # one key may hold host arrays and device tensors alike: stack on the device of the first tensor
        dev = next((x.device for b in batches for x in (*b[0], *b[1].values()) if isinstance(x, Tensor)), None)
        stacked_args = tuple(torch.stack([torch.as_tensor(b[0][i], device=dev) for b in batches])
                             for i in range(len(first_args)))
        stacked_kwargs = {name: torch.stack([torch.as_tensor(b[1][name], device=dev) for b in batches])
                          for name in first_kwargs}
        self._target.update_batches(*stacked_args, **stacked_kwargs)

    def compute(self) -> Any:
        """Flush pending batches, then compute the target."""
        self.flush()
        return self._target.compute()

    def reset(self) -> None:
        """Drop pending batches and reset the target."""
        self._discard()
        self._target.reset()

    def _discard(self) -> int:
        """Drop pending batches and disarm the stale-state guard; returns the number dropped."""
        n = len(self._pending)
        self._pending.clear()
        self._pending_key = None
        self._set_pending(0)
        return n

    def __enter__(self) -> "BufferedUpdater":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        """Flush on a clean exit; discard and warn on an error exit. Either way the guard is
        disarmed before control leaves the block, a failed flush included."""
        if exc_type is None:
            try:
                self.flush()
            except BaseException:
                self._discard()
                raise
            return False
        dropped = self._discard()
        if dropped:
            rank_zero_warn(
                f"BufferedUpdater context exited with {exc_type.__name__}: discarded"
                f" {dropped} pending batch(es). The metric state holds only the batches"
                " flushed before the error; the metric remains usable.",
                UserWarning,
            )
        return False

    def __len__(self) -> int:
        return len(self._pending)


def guard_buffered_pending(metric: Any, op: str) -> None:
    """Raise when ``metric`` is touched while a :class:`BufferedUpdater` holds its batches."""
    pending = metric.__dict__.get("_buffered_pending", 0)
    if pending:
        raise TorchMetricsUserError(
            f"Cannot run {op!r} on {type(metric).__name__}: {pending} batch(es) are pending"
            " in a buffered accumulator, so the metric state is stale mid-flight. Call"
            " flush() on the buffer (or use its compute(), which flushes first)."
        )
