"""Windowed metric state: sliding rings and EMA decay as fixed-shape states (counterpart of
``torchmetrics_tpu/online/windowed.py``).

- **State.** :class:`Windowed` wraps a template metric and registers every template tensor state
  again with a leading ``(window, ...)`` ring axis: ``window`` tumbling sub-window slabs, each
  accumulated by the template's OWN ``_update``, plus three int32 bookkeeping states
  (``window_slot``, ``window_count``, ``window_advances``). The ring is an ordinary fixed-shape
  state, so the dispatch tiers (a captured graph per input signature on the card), ``buffered``,
  ``update_batches`` and sync apply unchanged.
- **The ring fold stays on the device.** The live slab is taken out with an ``index_select`` at
  the slot, a 0-d device tensor, so the template's ``_update`` gets a fresh row, not a view into
  the ring (a kernel wrapper that writes its output cannot touch other slots), and written back
  with an ``index_copy``. With ``advance_every=n`` the update itself rotates the ring after the
  slot's n-th update: the pointer moves, the slab it moves into is reset to the template's
  defaults and the advance counter moves, all ``torch.where`` selects over fixed shapes. No
  value is read back to the host, so window boundaries are a pure function of the update count.
- **Compute merges the live sub-windows** by the template's reductions: ``sum`` states fold as
  ``default + Σ(slab - default)``, ``max``/``min`` reduce along the ring axis, and a callable merge
  declared ``traceable`` (the KLL compactor's ``kll_merge_stacked``) takes the ring as its stacked
  operand. For named reductions over integer-valued data the window value is bit-identical to a
  fresh metric fed exactly the window's batches; for a sketch it is bit-identical to merging the
  per-sub-window sketches.
- **EMA** (:class:`Ema`): one decay multiply of the sum-reduced state before the template folds
  the batch in, per update (not per wall-clock second). Its states are floating: where the
  port's template keeps an int64 count (the classification counts), :class:`Ema` holds it in
  float32, the dtype the JAX package decays, since a decayed count is fractional.

Per-window observability: each advance bumps ``online.windows_advanced`` and, with ``emit=True``,
records the sliding value into the always-on ``online.<Template>.w<window>`` series and gauge:
one deliberate device read per advance. Validation stays on the host, outside the graph: both
wrappers take the template's ``_validate``, ``_should_validate`` and ``_coerce``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.ops import dispatch as _dispatch
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

_SUM_FX = ("sum",)
_MAX_FX = ("max",)
_MIN_FX = ("min",)

#: bookkeeping states registered beside the ring slabs (reserved names)
SLOT_STATE = "window_slot"
COUNT_STATE = "window_count"
ADVANCES_STATE = "window_advances"
_BOOKKEEPING = (SLOT_STATE, COUNT_STATE, ADVANCES_STATE)


def _slotwise_merge(fx: Callable) -> Callable:
    """Slot-wise twin of a capturable merge callable for ``(window, ...)`` ring states.

    Sync stacks per-rank states to ``(world, window, ...)`` while the template's merge takes
    ``(world, ...)``: each ring slot is merged across ranks on its own (a loop over the fixed,
    small number of slots), so each slot's bits are those of merging that slot alone.
    """

    def slotwise(stacked: Tensor) -> Tensor:
        return torch.stack([fx(stacked[:, i]) for i in range(stacked.shape[1])])

    slotwise.traceable = True
    slotwise.__name__ = f"windowed_{getattr(fx, '__name__', 'merge')}"
    return slotwise


def _host(value: Any) -> np.ndarray:
    """A value as a host numpy array: one copy from the device for a tensor."""
    if isinstance(value, Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _resolve_template(metric: Union[Metric, type], kind: str, kwargs: Dict[str, Any]) -> Metric:
    """The template instance (a class is built on the wrapper's device); ``kwargs`` gets the
    template's device when the caller named none."""
    if isinstance(metric, type):
        if not issubclass(metric, Metric):
            raise ValueError(f"Expected a Metric instance or subclass, got {metric!r}")
        metric = metric(device=kwargs.get("device"))
    if not isinstance(metric, Metric):
        raise ValueError(f"Expected a Metric instance or subclass, got {metric!r}")
    kwargs.setdefault("device", metric.device)
    return metric


def _check_template(metric: Metric, kind: str) -> Metric:
    """JAX ``windowed.py:94``, with its messages."""
    if isinstance(metric, (Windowed, Ema)):
        raise ValueError(f"{kind} cannot be nested: pass the plain template metric")
    if metric._state.lists:
        raise TorchMetricsUserError(
            f"{type(metric).__name__} holds list ('cat') states, which have no fixed"
            f" per-window shape — only tensor-state metrics can be {kind.lower()}ed."
            " Bound the state first (e.g. a binned/sketched variant) and window that."
        )
    if not (metric.jit_update and metric.jit_compute):
        raise TorchMetricsUserError(
            f"{type(metric).__name__} opts out of jit (jit_update/jit_compute=False):"
            f" its kernels cannot trace into the fused {kind.lower()}ed program."
        )
    for name in metric._state.tensors:
        if name in _BOOKKEEPING:
            raise TorchMetricsUserError(
                f"{type(metric).__name__} registers a state named {name!r}, which is"
                f" reserved for {kind}'s ring bookkeeping."
            )
    return metric


class _TemplateWrapper(Metric):
    """What both wrappers share: the template, host-side validation through it, and the device
    moves and casts that must reach its defaults too."""

    def _adopt(self, metric: Metric) -> Metric:
        if metric.device != self.device:
            metric = metric.clone().to(self.device)
        self._template = metric
        self._tpl_names = tuple(metric._state.tensors)
        return metric

    @property
    def template(self) -> Metric:
        """The template metric the per-slot kernels come from (never updated itself)."""
        return self._template

    @property
    def series_name(self) -> str:
        """The ``online.*`` live-series name the emissions record into."""
        return self._series_name

    # validation runs on the host before any graph step, with the template's own checks
    def _validate(self, *args: Any, **kwargs: Any) -> None:
        self._template._validate(*args, **kwargs)

    def _should_validate(self) -> bool:
        return self._template._should_validate()

    def _coerce(self, args: tuple, kwargs: dict) -> tuple:
        return self._template._coerce(args, kwargs)

    def to(self, device: Union[str, torch.device]) -> "_TemplateWrapper":
        super().to(device)
        self._template.to(self.device)
        return self

    def set_dtype(self, dst_type: torch.dtype) -> "_TemplateWrapper":
        super().set_dtype(dst_type)
        self._template.set_dtype(dst_type)
        return self

    def _emit(self, value: Any) -> None:
        """Record a scalar window value into the live series and gauge (one device read)."""
        arr = _host(value)
        if arr.size != 1:
            # no single dashboard number (a keyed template's per-key vector, several quantiles);
            # the advance counter still fired, and consumers read window_values()
            obs.telemetry.counter("online.emit_skipped").inc()
            return
        v = float(arr.reshape(()))
        obs.telemetry.series(self._series_name, device=self.device).record(v)
        obs.telemetry.gauge(self._series_name).set(v)
        obs.telemetry.counter("online.emitted").inc()


class Windowed(_TemplateWrapper):
    """Sliding-window view of a template metric: a ring of tumbling sub-window slabs.

    ``window`` is the number of sub-windows in the ring; ``advance_every`` (updates per
    sub-window) drives the on-device rotation, so :meth:`compute` always covers the last
    ``window`` sub-windows (the live, partly filled one included). With ``advance_every=None``
    the ring rotates only on explicit :meth:`advance` calls.

    Example:
        >>> import numpy as np
        >>> from torchmetrics_tpu_torch.aggregation import SumMetric
        >>> from torchmetrics_tpu_torch.online import Windowed
        >>> w = Windowed(SumMetric(device="cpu"), window=2, advance_every=2, emit=False)
        >>> for v in (1.0, 2.0, 4.0, 8.0, 16.0):
        ...     w.update(np.asarray([v], np.float32))
        >>> float(w.compute())  # last 2 sub-windows: (4+8) + 16
        28.0
        >>> w.windows_advanced
        2
    """

    #: update-only protocol: every update is one graph replay on the card
    fast_update = True
    #: the ring fold does not decompose under segment reductions
    keyed_decomposable = False

    def __init__(
        self,
        metric: Union[Metric, type],
        window: int,
        advance_every: Optional[int] = None,
        emit: bool = True,
        series: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        metric = _resolve_template(metric, "Windowed", kwargs)
        super().__init__(**kwargs)
        metric = self._adopt(_check_template(metric, "Windowed"))
        window = int(window)
        if window < 1:
            raise ValueError(f"Windowed needs window >= 1, got {window}")
        if advance_every is not None:
            advance_every = int(advance_every)
            if advance_every < 1:
                raise ValueError(f"Windowed needs advance_every >= 1, got {advance_every}")
        self.window = window
        self.advance_every = advance_every
        self._emit_values = bool(emit)
        self._series_name = series or f"online.{type(metric).__name__}.w{window}"
        for name in self._tpl_names:
            fx = metric._reductions[name]
            if fx in _SUM_FX or fx in _MAX_FX or fx in _MIN_FX:
                ring_fx: Any = fx
            elif callable(fx) and getattr(fx, "traceable", False):
                ring_fx = _slotwise_merge(fx)
            else:
                raise TorchMetricsUserError(
                    f"{type(metric).__name__} state {name!r} has dist_reduce_fx={fx!r},"
                    " which the window merge ladder cannot fold — windowed states need"
                    " sum/max/min or a trace-safe callable merge (sketch states)."
                )
            default = metric._defaults[name]
            self.add_state(name, default.expand((window,) + tuple(default.shape)), dist_reduce_fx=ring_fx)
        # all ranks advance in step, so "max" is the identity sync of the bookkeeping
        for name in _BOOKKEEPING:
            self.add_state(name, torch.tensor(0, dtype=torch.int32), dist_reduce_fx="max")
        self._advances_seen = 0

    # ------------------------------------------------------------------ properties
    @property
    def windows_advanced(self) -> int:
        """Total ring advances so far (counted on the host; no device read)."""
        return self._advances_seen

    @property
    def online_descriptor(self) -> Dict[str, Any]:
        """The ``window`` descriptor of a snapshot: two rings of another geometry or advance
        cadence are not the same state even where their arrays agree in shape."""
        return {
            "mode": "sliding",
            "window": int(self.window),
            "advance_every": None if self.advance_every is None else int(self.advance_every),
            "template": type(self._template).__name__,
        }

    # ------------------------------------------------------------------ kernels
    def _reset_row(self, ring: Tensor, index: Tensor, when: Optional[Tensor], name: str) -> Tensor:
        """``ring`` with the slab at ``index`` (a 1-element device index) set to the template's
        default, where ``when`` (a 0-d device bool, or None for always) holds."""
        fill = self._template._defaults[name].unsqueeze(0)
        if when is not None:
            fill = torch.where(when, fill, ring.index_select(0, index))
        return ring.index_copy(0, index, fill)

    def _update(self, state: Dict[str, Tensor], *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        slot = state[SLOT_STATE]
        index = slot.reshape(1).to(torch.int64)
        # a fresh row per state (index_select copies): the template never sees a view of the ring
        row_state = {n: state[n].index_select(0, index)[0] for n in self._tpl_names}
        out = self._template._update(dict(row_state), *args, **kwargs)
        new: Dict[str, Tensor] = {}
        for n in self._tpl_names:
            new[n] = state[n].index_copy(0, index, out.get(n, row_state[n]).unsqueeze(0))
        count = state[COUNT_STATE] + 1
        advances = state[ADVANCES_STATE]
        if self.advance_every is not None:
            # the moment a sub-window fills, rotate the pointer and reset the slab it moves into
            # (dropping the oldest sub-window): a compute between updates never sees a stale one
            do_adv = count >= self.advance_every
            nxt = torch.remainder(slot + 1, self.window)
            nxt_index = nxt.reshape(1).to(torch.int64)
            for n in self._tpl_names:
                new[n] = self._reset_row(new[n], nxt_index, do_adv, n)
            slot = torch.where(do_adv, nxt, slot)
            count = torch.where(do_adv, torch.zeros_like(count), count)
            advances = advances + do_adv.to(advances.dtype)
        new[SLOT_STATE] = slot
        new[COUNT_STATE] = count
        new[ADVANCES_STATE] = advances
        return new

    def _merge_ring(self, state: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Fold the ``(window, ...)`` slabs into one template state by the template's reductions:
        empty slabs are exact identities (zero sum contribution, infinite extrema, the empty
        sketch)."""
        tpl = self._template
        merged: Dict[str, Tensor] = {}
        for n in self._tpl_names:
            fx = tpl._reductions[n]
            v = state[n]
            if fx in _SUM_FX:
                d = tpl._defaults[n]
                merged[n] = d + torch.sum(v - d, dim=0)
            elif fx in _MAX_FX:
                merged[n] = torch.amax(v, dim=0)
            elif fx in _MIN_FX:
                merged[n] = torch.amin(v, dim=0)
            else:  # a capturable callable: the ring IS the stacked-merge operand
                merged[n] = fx(v)
        return merged

    def _compute(self, state: Dict[str, Any]) -> Any:
        return self._template._compute(self._merge_ring(state))

    def _advance_state(self, state: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The manual advance: pointer forward, the slab it moves into reset to the defaults."""
        nxt = torch.remainder(state[SLOT_STATE] + 1, self.window)
        index = nxt.reshape(1).to(torch.int64)
        new = dict(state)
        for n in self._tpl_names:
            new[n] = self._reset_row(state[n], index, None, n)
        new[SLOT_STATE] = nxt
        new[COUNT_STATE] = torch.zeros_like(state[COUNT_STATE])
        new[ADVANCES_STATE] = state[ADVANCES_STATE] + 1
        return new

    def _ring_step(self, key: str, fn: Callable[[Dict[str, Tensor]], Any]) -> Any:
        """``fn`` of the current state, one captured graph per ``key`` on the card (its values
        copied out), else eagerly; never a graph's static buffer or a view of the live state."""
        _dispatch.guard_buffered_pending(self, key)
        self._state.guard_readable()
        names = tuple(self._state.tensors)
        tensors = tuple(self._state.tensors.values())
        return self._own(self._graph_compute(key, lambda *ts: fn(dict(zip(names, ts))), tensors, op=key))

    # ------------------------------------------------------------------ protocol
    def update(self, *args: Any, **kwargs: Any) -> None:
        """Fold one batch into the live sub-window (rotating on the device when it fills)."""
        super().update(*args, **kwargs)
        self._online_tick()

    def update_batches(self, *args: Any, **kwargs: Any) -> None:
        """Whole-stack sweep; the ring rotations inside it are counted (and the latest window
        value emitted once) on return."""
        super().update_batches(*args, **kwargs)
        self._online_tick()

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        raise TorchMetricsUserError(
            "Windowed has no per-batch forward value: the window merge is not a batch"
            " reduction. Drive it with update(...) and read the sliding value with"
            " compute() (or the online.* live series the advances emit)."
        )

    def advance(self) -> None:
        """Manually close the live sub-window (only with ``advance_every=None``): one captured
        step on the card, pointer forward and the slab it moves into reset to the defaults."""
        if self.advance_every is not None:
            raise TorchMetricsUserError(
                f"This Windowed metric auto-advances every {self.advance_every}"
                " update(s); mixing manual advance() calls in would make the window"
                " boundaries irreproducible under journal replay."
            )
        _dispatch.guard_buffered_pending(self, "advance")
        self._quiesce()
        self._state.guard_readable()
        advance = self._advance_state

        def build(slab, count, s_args, s_kwargs):
            return lambda: (None, advance(dict(slab)))

        obs.count_dispatch(self)
        if not (self._graph_gate("window_advance") and self._run_graph("window_advance", (), (), {}, build)
                is not _dispatch.MISS):
            self._state.tensors.update(advance(dict(self._state.tensors)))
        self._computed = None
        self._advances_seen += 1
        obs.telemetry.counter("online.windows_advanced").inc()
        if self._emit_values:
            self._emit_window_value()

    # ------------------------------------------------------------- observability
    def _online_tick(self) -> None:
        """Host tail of every update: count the on-device advances (update-count arithmetic, no
        device read) and emit the sliding value once per batch of new advances."""
        if self.advance_every is None:
            return
        total = self._update_count // self.advance_every
        new = total - self._advances_seen
        if new <= 0:
            return
        self._advances_seen = total
        obs.telemetry.counter("online.windows_advanced").inc(new)
        if self._emit_values:
            self._emit_window_value()

    def _emit_window_value(self) -> None:
        """One deliberate device read per advance: the freshly closed window's sliding value into the
        always-on ``online.*`` series and gauge."""
        self._emit(self.window_values())

    def window_state(self) -> Dict[str, Tensor]:
        """The merged template state over the live ring, as copies (one captured step on the card;
        the drift detectors read sketch states from here)."""
        self._quiesce()
        return dict(self._ring_step("window_state", self._merge_ring))

    def window_values(self) -> Any:
        """The sliding window's computed value, with no sync: what an advance emits (a no-op quiesce from the
        serving drain, which emits it after the updates it applies)."""
        self._quiesce()
        return self._ring_step("window_values", self._compute)

    # ------------------------------------------------------------------ lifecycle
    def reset(self) -> None:
        super().reset()
        self._advances_seen = 0

    def restore(self, blob: Dict[str, Any]) -> None:
        """Restore the ring from a snapshot blob (JAX ``windowed.py:409``), then set the host's advance count
        from the restored ring's (one device read), so that emission does not replay a burst."""
        super().restore(blob)
        self._advances_seen = int(self._state.tensors[ADVANCES_STATE].item())

    def __repr__(self) -> str:
        return (f"{type(self).__name__}({type(self._template).__name__}(),"
                f" window={self.window}, advance_every={self.advance_every})")


class Ema(_TemplateWrapper):
    """Exponentially decayed view of a template metric: one decay multiply per update.

    Every template state must be sum-reduced (``SumMetric``, ``MeanMetric``'s pair, the curve
    family's binned confmat and histogram pair, the stat-score counts): the update decays the
    state by ``decay`` before the template folds the batch in, so after ``t`` updates batch ``i``
    weighs ``decay^(t-i)``. The states are floating, float32 where the template counts in int64.
    ``emit_every=n`` records the decayed value into the ``online.<Template>.ema`` series every
    ``n`` updates.

    Example:
        >>> import numpy as np
        >>> from torchmetrics_tpu_torch.aggregation import SumMetric
        >>> from torchmetrics_tpu_torch.online import Ema
        >>> m = Ema(SumMetric(device="cpu"), decay=0.5)
        >>> for v in (1.0, 1.0, 1.0):
        ...     m.update(np.asarray([v], np.float32))
        >>> float(m.compute())  # 0.25 + 0.5 + 1
        1.75
    """

    fast_update = True
    keyed_decomposable = False

    def __init__(
        self,
        metric: Union[Metric, type],
        decay: float = 0.99,
        emit_every: Optional[int] = None,
        series: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        metric = _resolve_template(metric, "Ema", kwargs)
        super().__init__(**kwargs)
        metric = self._adopt(_check_template(metric, "Ema"))
        decay = float(decay)
        if not (0.0 < decay <= 1.0):
            raise ValueError(f"Ema needs decay in (0, 1], got {decay}")
        if emit_every is not None:
            emit_every = int(emit_every)
            if emit_every < 1:
                raise ValueError(f"Ema needs emit_every >= 1, got {emit_every}")
        for name, fx in metric._reductions.items():
            if fx not in _SUM_FX:
                raise TorchMetricsUserError(
                    f"{type(metric).__name__} state {name!r} has dist_reduce_fx={fx!r};"
                    " EMA decay is only well-defined for sum-reduced states (decaying"
                    " an extremum or a sketch has no exponential-weighting meaning)."
                    " Use Windowed for bounded-horizon semantics instead."
                )
        self.decay = decay
        self.emit_every = emit_every
        self._series_name = series or f"online.{type(metric).__name__}.ema"
        self._emitted_at = 0
        for name in self._tpl_names:
            default = metric._defaults[name]
            # a decayed count is fractional: an integer count is held in float32, as JAX holds it
            floating = default if default.is_floating_point() else default.to(torch.float32)
            self.add_state(name, floating, dist_reduce_fx=metric._reductions[name])

    @property
    def online_descriptor(self) -> Dict[str, Any]:
        """The ``window`` descriptor of a snapshot: the decay is part of the state's meaning."""
        return {"mode": "ema", "decay": float(self.decay), "template": type(self._template).__name__}

    def _update(self, state: Dict[str, Tensor], *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        decayed = {}
        for n in self._tpl_names:
            d = self._defaults[n]
            # default + decay·contribution: exact for any sum default, zero or not
            decayed[n] = d + self.decay * (state[n] - d)
        out = self._template._update(decayed, *args, **kwargs)
        return {n: out.get(n, decayed[n]).to(decayed[n].dtype) for n in self._tpl_names}

    def _compute(self, state: Dict[str, Any]) -> Any:
        return self._template._compute({n: state[n] for n in self._tpl_names})

    def update(self, *args: Any, **kwargs: Any) -> None:
        super().update(*args, **kwargs)
        self._online_tick()

    def update_batches(self, *args: Any, **kwargs: Any) -> None:
        super().update_batches(*args, **kwargs)
        self._online_tick()

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        raise TorchMetricsUserError(
            "Ema has no per-batch forward value: the decayed merge is not the engine's"
            " batch reduction. Drive it with update(...) and read compute()."
        )

    def _online_tick(self) -> None:
        if self.emit_every is None:
            return
        due = self._update_count // self.emit_every
        if due <= self._emitted_at:
            return
        self._emitted_at = due
        names = tuple(self._state.tensors)
        self._emit(self._graph_compute("ema_value", lambda *ts: self._compute(dict(zip(names, ts))),
                                       tuple(self._state.tensors.values()), op="ema_value"))

    def reset(self) -> None:
        super().reset()
        self._emitted_at = 0

    def __repr__(self) -> str:
        return f"{type(self).__name__}({type(self._template).__name__}(), decay={self.decay})"
