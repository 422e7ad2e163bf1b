"""The keyed multi-tenant engine: ``KeyedMetric`` and ``KeyedMetricCollection`` (counterpart of
``torchmetrics_tpu/keyed/engine.py``).

- **State.** Every tensor state of the template metric is registered again with a leading
  ``(num_keys, ...)`` tenant axis: the whole tenant table is one fixed-shape state per template
  state, so the dispatch tiers and sync see an ordinary metric with bigger states. List (``cat``)
  states cannot be keyed.
- **Update** (``update(key_ids, *batch)``), one program either way:

  * ``segments``, for templates whose every state merges by ``sum``, ``max`` or ``min``: the
    template's own ``_update`` is vmapped (``torch.func.vmap``) over the batch's elements against
    the defaults, so its masking, NaN and dtype rules are the template's, and each state's
    per-element contributions are folded into the table by one segment reduction. A sum runs over
    the keys' runs after a stable sort (``ops.segments.sorted_segment_reduce``): each key's
    contributions add in input order on both tiers and both devices, where a float ``index_add_``
    adds with atomics. Max and min take ``scatter_reduce`` (exact in any order). Cost ``O(batch)``.
    A template whose update launches kernel K2 (the sketched curves, ``StreamingHistogram``) reaches
    it through the op's vmap rule (``ops/hist_pair.py``): one launch for the whole batch.
  * ``vmap``, for the others (``StreamingQuantile``: ``keyed_decomposable = False``): the per-key
    sequential fold. Each key's elements go through the template's update one at a time in input
    order, so each key's state equals a per-key instance fed its elements one at a time. The JAX
    package scans the whole batch once per key (``O(num_keys x batch)``); the port takes the keys in
    step: a stable sort gives each element its rank within its key, and step ``r`` runs the
    template's update vmapped over the rows of the keys that have an ``r``-th element. The depth is
    the largest count of one key in the batch (read on the host with the ids, rounded up to a power
    of two: one graph per depth), not the batch size (:meth:`KeyedMetric._vmap_update`).

- **Compute** (``compute()``, ``compute(keys=...)``): the template's ``_compute`` vmapped over the
  requested rows of the table, every key in one program. A compute that read the host or branched
  on a value could not run under vmap; none of the templates keyed here does: ``Sum``, ``Mean``,
  ``Max`` and ``MinMetric`` (``_safe_divide`` masks, it does not branch), the sketched curves
  (``BinaryAUROC``, ``BinaryAveragePrecision``, ``BinaryROC`` with ``approx="sketch"``: suffix sums
  and trapezoids over fixed shapes), ``StreamingHistogram`` (the state itself),
  ``StreamingQuantile`` (sort, cumsum, ``searchsorted``, a gather and a ``where``) and the sum-state
  regression errors all vmap, and give the JAX package's values (``tests/test_torch_keyed.py``).
- **Key checks.** ``update`` reads the ids on the host once: range errors with the JAX package's
  text, the ``active_keys`` count and the JAX package's telemetry counters (``keyed.fanout``,
  ``keyed.active_keys``, ``keyed.updates``). The keyed snapshot and journal, and ``Metric.shard()``,
  are not ported yet (ROADMAP.md, queue A, item 9).

``update``, ``update_batches`` and ``buffered`` run on the port's dispatch tiers: on the card the
keyed update is one captured CUDA graph per input signature (``fast_update``), eager elsewhere.
``forward`` raises, as in the JAX package: a mixed-tenant batch has one value per key.

Classification templates are not keyed, as in the JAX package: a per-element vmap strips the
batch axis that their input formatting reads, and the update raises (ROADMAP.md, queue C).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import Tensor
from torch.utils._pytree import tree_map

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.ops import dispatch as _dispatch
from torchmetrics_tpu_torch.ops import segments as _segments
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

#: update-routing strategies: "auto" picks segments when the template decomposes
STRATEGIES = ("auto", "segments", "vmap")
_DECOMPOSABLE = ("sum", "max", "min")


def _in_dims(tree: Any) -> Any:
    """vmap ``in_dims`` for a pytree of inputs: 0 for each tensor, None for anything else."""
    return tree_map(lambda x: 0 if isinstance(x, Tensor) else None, tree)


def _depth_of(ids: np.ndarray, num_keys: int) -> int:
    """The vmap fold's depth for a stack of id rows (one row a batch): the largest count of one key
    in [0, ``num_keys``) in a row, rounded up to a power of two so that a few graphs serve every batch."""
    ids = ids.astype(np.int64)
    keep = (ids >= 0) & (ids < num_keys)
    cells = (np.arange(ids.shape[0])[:, None] * num_keys + ids)[keep]
    most = int(np.unique(cells, return_counts=True)[1].max()) if cells.size else 1
    return 1 << (most - 1).bit_length()


class KeyedMetric(Metric):
    """One metric, ``num_keys`` independent streams, one program per batch.

    ``metric`` is the template: an instance, or a class built with the keyed metric's device. Its
    ``_update``, ``_compute`` and registered states define the per-key semantics; the template
    itself is never updated. A template instance on another device than ``device`` is cloned there.

    Example:
        >>> import numpy as np
        >>> from torchmetrics_tpu_torch.aggregation import SumMetric
        >>> from torchmetrics_tpu_torch.keyed import KeyedMetric
        >>> km = KeyedMetric(SumMetric, num_keys=4, device="cpu")
        >>> km.update(np.array([0, 2, 0, 2]), np.array([1.0, 10.0, 2.0, 20.0]))
        >>> km.compute().tolist()
        [3.0, 0.0, 30.0, 0.0]
        >>> km.compute(keys=[2]).tolist()
        [30.0]
    """

    #: the keyed update is an update-only protocol: it takes the ``fast_update`` graph tier
    fast_update = True

    def __init__(
        self,
        metric: Union[Metric, type],
        num_keys: int,
        strategy: str = "auto",
        validate_keys: bool = True,
        **kwargs: Any,
    ) -> None:
        if isinstance(metric, type):
            if not issubclass(metric, Metric):
                raise ValueError(f"Expected a Metric instance or subclass, got {metric!r}")
            metric = metric(device=kwargs.get("device"))
        if not isinstance(metric, Metric):
            raise ValueError(f"Expected a Metric instance or subclass, got {metric!r}")
        kwargs.setdefault("device", metric.device)
        super().__init__(**kwargs)
        if isinstance(metric, KeyedMetric):
            raise ValueError("KeyedMetric cannot be nested: pass the plain template metric")
        num_keys = int(num_keys)
        if num_keys < 1:
            raise ValueError(f"KeyedMetric needs num_keys >= 1, got {num_keys}")
        if metric._state.lists:
            raise TorchMetricsUserError(
                f"{type(metric).__name__} holds list ('cat') states, which have no fixed"
                " per-key shape — only tensor-state metrics can be keyed. Bound the state"
                " first (e.g. a binned/sketched variant) and key that."
            )
        if not (metric.jit_update and metric.jit_compute):
            raise TorchMetricsUserError(
                f"{type(metric).__name__} opts out of jit (jit_update/jit_compute=False):"
                " its kernels cannot trace into the fused keyed program."
            )
        if metric.device != self.device:
            metric = metric.clone().to(self.device)
        self._template = metric
        self.num_keys = num_keys
        self.validate_keys = bool(validate_keys)
        self._tpl_names = tuple(metric._state.tensors)
        self._strategy = self._resolve_strategy(strategy)
        for name in self._tpl_names:
            default = metric._defaults[name]
            self.add_state(name, default.expand(num_keys, *default.shape), dist_reduce_fx=metric._reductions[name])
        # which keys ever saw an update, counted on the host
        self._seen_keys = np.zeros(num_keys, dtype=bool)
        self._active_count = 0
        # the vmap fold's depth for the update in flight, from the host read of its ids
        self._fold_depth: Optional[int] = None

    # ------------------------------------------------------------------ strategy
    def _decomposable(self) -> bool:
        """Whether every template state merges per element under a segment reduction."""
        return all(self._template._reductions[name] in _DECOMPOSABLE for name in self._tpl_names)

    def _resolve_strategy(self, strategy: str) -> str:
        if strategy not in STRATEGIES:
            raise ValueError(f"KeyedMetric strategy must be one of {STRATEGIES}, got {strategy!r}")
        if strategy == "segments":
            if not self._decomposable():
                raise TorchMetricsUserError(
                    f"{type(self._template).__name__} does not decompose under segment"
                    " reductions (a state's dist_reduce_fx is not sum/max/min) — use"
                    " strategy='vmap' (or 'auto')."
                )
            return strategy
        if strategy == "vmap":
            return strategy
        hint = type(self._template).keyed_decomposable
        if hint is not None:
            return "segments" if hint else "vmap"
        return "segments" if self._decomposable() else "vmap"

    @property
    def strategy(self) -> str:
        """Resolved update-routing strategy: ``"segments"`` or ``"vmap"``."""
        return self._strategy

    @property
    def template(self) -> Metric:
        """The template metric the per-key kernels come from (never updated itself)."""
        return self._template

    @property
    def active_keys(self) -> int:
        """Keys this instance has seen at least one update for."""
        return self._active_count

    # ------------------------------------------------------------------ kernels
    def _update(self, state: Dict[str, Tensor], key_ids: Tensor, *args: Any, **kwargs: Any) -> Dict[str, Tensor]:
        if key_ids.is_floating_point() or key_ids.is_complex() or key_ids.dtype == torch.bool:
            raise TorchMetricsUserError(f"key_ids must be an integer array, got dtype {key_ids.dtype}")
        key_ids = key_ids.reshape(-1)
        if self._strategy == "segments":
            return self._segment_update(state, key_ids, args, kwargs)
        return self._vmap_update(state, key_ids, args, kwargs)

    def _segment_update(self, state: Dict[str, Tensor], key_ids: Tensor, args: tuple, kwargs: dict) -> Dict[str, Tensor]:
        """Per-element contributions through the template's own update, one segment reduction per state."""
        tpl = self._template
        names = self._tpl_names
        defaults = {n: tpl._defaults[n] for n in names}
        upd = tpl._update

        def elem(e_args: tuple, e_kwargs: dict) -> Dict[str, Tensor]:
            out = upd(dict(defaults), *e_args, **e_kwargs)
            return {n: out.get(n, defaults[n]) for n in names}

        contribs = torch.func.vmap(elem, in_dims=(_in_dims(args), _in_dims(kwargs)))(args, kwargs)
        n_keys = self.num_keys
        order = torch.sort(key_ids, stable=True)
        offsets = _segments.segment_offsets(order.values, n_keys)
        new: Dict[str, Tensor] = {}
        for name in names:
            fx, cur, c = self._reductions[name], state[name], contribs[name]
            if fx == "sum":
                # the contribution includes the default: subtracting it keeps a non-zero default exact
                seg = _segments.sorted_segment_reduce((c - defaults[name])[order.indices], offsets, "sum")
                new[name] = cur + seg.to(cur.dtype)
            elif fx == "max":  # empty segments hold the identity (-inf): a no-op merge
                new[name] = torch.maximum(cur, _segments.segment_max(c, key_ids, n_keys).to(cur.dtype))
            else:  # "min": _resolve_strategy lets nothing else through
                new[name] = torch.minimum(cur, _segments.segment_min(c, key_ids, n_keys).to(cur.dtype))
        return new

    def _vmap_update(self, state: Dict[str, Tensor], key_ids: Tensor, args: tuple, kwargs: dict) -> Dict[str, Tensor]:
        """The per-key sequential fold (JAX ``engine.py:234-258``), keys in step. A stable sort of the
        ids gives each element its key's slot (one row per key present) and its rank within the key;
        step ``r`` gathers every slot's ``r``-th element, runs the template update vmapped over the
        slots' rows, and keeps the result where the slot has that element. Each key sees its own
        elements in input order, as a per-key instance would, so the bits are the same; the depth is
        ``_fold_depth`` (a power of two at least the largest count of one key), not the batch size.
        Slots with no key, and owners outside ``[0, num_keys)`` (``validate_keys=False``), change
        nothing."""
        n_keys = self.num_keys
        depth = self._fold_depth or _depth_of(key_ids.cpu().numpy()[None], n_keys)
        n = key_ids.shape[0]
        if n == 0:
            return {name: state[name] for name in self._tpl_names}
        slots = min(n, n_keys)
        ids = key_ids.to(torch.int64)
        order = torch.sort(torch.where((ids >= 0) & (ids < n_keys), ids, n_keys), stable=True)
        sorted_ids = order.values
        start = torch.ones_like(sorted_ids, dtype=torch.bool)
        start[1:] = sorted_ids[1:] != sorted_ids[:-1]
        slot = torch.cumsum(start, 0) - 1
        rank = torch.arange(n, device=ids.device) - _segments.segment_offsets(sorted_ids, n_keys)[sorted_ids]
        owned = sorted_ids < n_keys
        # (slots, depth) element table, -1 where a slot has no element of that rank; the last cell takes the rest
        cells = torch.full((slots * depth + 1,), -1, dtype=torch.int64, device=ids.device)
        cells.scatter_(0, torch.where(owned, slot * depth + rank, slots * depth), order.indices)
        cells = cells[:-1].reshape(slots, depth)
        slot_key = torch.full((slots + 1,), n_keys, dtype=torch.int64, device=ids.device)
        slot_key.scatter_(0, torch.where(owned & start, slot, slots), sorted_ids)
        slot_key = slot_key[:-1]
        used = slot_key < n_keys
        # an unused slot writes back the first slot's row under its key: equal values at one index
        slot_key = torch.where(used, slot_key, torch.clamp(slot_key[0], max=n_keys - 1))
        names = self._tpl_names
        rows = {name: state[name].index_select(0, slot_key) for name in names}
        upd = self._template._update

        def step(row: Dict[str, Tensor], e_args: tuple, e_kwargs: dict) -> Dict[str, Tensor]:
            out = upd(dict(row), *e_args, **e_kwargs)
            return {name: out.get(name, row[name]) for name in names}

        def per_row(mask: Tensor, a: Tensor, b: Tensor) -> Tensor:
            return torch.where(mask.reshape(-1, *(1,) * (a.dim() - 1)), a, b)

        batched = torch.func.vmap(step, in_dims=(0, _in_dims(args), _in_dims(kwargs)))
        for r in range(depth):
            element = cells[:, r]
            index = torch.clamp(element, min=0)
            pick = lambda a: a.index_select(0, index) if isinstance(a, Tensor) else a  # noqa: E731
            out = batched(rows, tree_map(pick, args), tree_map(pick, kwargs))
            rows = {name: per_row(element >= 0, out[name], rows[name]) for name in names}
        return {name: state[name].index_copy(0, slot_key, per_row(used, rows[name], rows[name][:1].expand_as(rows[name])))
                for name in names}

    def _compute(self, state: Dict[str, Any]) -> Any:
        """Finalise every stream: the template's compute vmapped over the tenant axis."""
        return torch.func.vmap(self._template._compute)({n: state[n] for n in self._tpl_names})

    # ------------------------------------------------------------------- protocol
    def _check_key_ids(self, key_ids: Any, args: tuple = (), kwargs: Optional[dict] = None,
                       stacked: bool = False) -> None:
        """Key checks, the active-key count and the vmap fold's depth, on one host read of the ids
        (``stacked``: one row of ids per batch, as ``update_batches`` takes them)."""
        if not args and not kwargs:
            raise TorchMetricsUserError("KeyedMetric.update needs the template metric's batch inputs after key_ids")
        ids = key_ids.cpu().numpy() if isinstance(key_ids, Tensor) else np.asarray(key_ids)
        if self.validate_keys:
            if ids.dtype.kind not in "iu":
                raise TorchMetricsUserError(f"key_ids must be an integer array, got dtype {ids.dtype}")
            if ids.size and (ids.min() < 0 or ids.max() >= self.num_keys):
                raise TorchMetricsUserError(
                    f"key_ids out of range: found values in [{ids.min()}, {ids.max()}],"
                    f" this KeyedMetric holds keys [0, {self.num_keys})."
                )
        if self._strategy == "vmap" and ids.dtype.kind in "iu":
            self._fold_depth = _depth_of(ids.reshape(ids.shape[0], -1) if stacked else ids.reshape(1, -1),
                                           self.num_keys)
        if ids.size and ids.dtype.kind in "iu":
            uniq = np.unique(ids)
            obs.telemetry.counter("keyed.fanout").inc(int(uniq.size))
            uniq = uniq[(uniq >= 0) & (uniq < self.num_keys)]
            newly = int(np.count_nonzero(~self._seen_keys[uniq]))
            if newly:
                self._seen_keys[uniq] = True
                self._active_count += newly
                obs.telemetry.counter("keyed.active_keys").inc(newly)

    def update(self, key_ids: Any, *args: Any, **kwargs: Any) -> None:
        """Fold one mixed-tenant batch into the tenant table, in one program.

        ``key_ids`` is an integer array of shape ``(batch,)``: element ``i`` belongs to stream
        ``key_ids[i]``; the other arguments are the template's update inputs with the same leading
        batch axis.
        """
        self._check_key_ids(key_ids, args, kwargs)
        obs.telemetry.counter("keyed.updates").inc()
        try:
            super().update(key_ids, *args, **kwargs)
        finally:
            self._fold_depth = None

    def update_batches(self, key_ids: Any, *args: Any, **kwargs: Any) -> None:
        """Whole-stack sweep: ``key_ids`` and the batch arguments carry an extra leading axis."""
        self._check_key_ids(key_ids, args, kwargs, stacked=True)
        obs.telemetry.counter("keyed.updates").inc(int(np.shape(key_ids)[0]))
        try:
            super().update_batches(key_ids, *args, **kwargs)
        finally:
            self._fold_depth = None

    def _run_graph(self, op: str, extra: Any, args: tuple, kwargs: dict, build: Any, *, counted: bool = False) -> Any:
        # the vmap fold's depth is read on the host with the ids: one graph per depth
        return super()._run_graph(op, (extra, self._fold_depth), args, kwargs, build, counted=counted)

    def compute(self, keys: Optional[Any] = None) -> Any:
        """Per-key values: every stream (shape ``(num_keys, ...)`` per output leaf) with ``keys=None``,
        else the requested rows of the table only, gathered and finalised (cost scales with
        ``len(keys)``), under the same sync, buffered-pending and poison guards as a plain ``compute()``
        (JAX ``keyed/engine.py:328``)."""
        if keys is None:
            return super().compute()
        _dispatch.guard_buffered_pending(self, "compute")
        self._quiesce()  # per-key gathers see every async batch too
        self._state.guard_readable()
        obs.bump(self, "compute_calls")
        self._guard_poison()
        keys_t = keys if isinstance(keys, Tensor) else torch.as_tensor(np.asarray(keys))
        keys_t = keys_t.reshape(-1)
        if self.validate_keys:
            ids = keys_t.cpu().numpy()
            if ids.dtype.kind not in "iu":
                raise TorchMetricsUserError(f"compute(keys=...) needs integer keys, got {ids.dtype}")
            if ids.size and (ids.min() < 0 or ids.max() >= self.num_keys):
                raise TorchMetricsUserError(
                    f"compute(keys=...) out of range: [{ids.min()}, {ids.max()}] vs [0, {self.num_keys})"
                )
        keys_t = keys_t.to(self.device)
        obs.count_dispatch(self)
        with obs.metric_span(self, "compute"), self.sync_context(
                dist_sync_fn=self.dist_sync_fn, should_sync=self._to_sync, should_unsync=self._should_unsync):
            value = self._compute({n: self._state.tensors[n][keys_t] for n in self._tpl_names})
        return self._own(value)

    def compute_key(self, key: int) -> Any:
        """One stream's value (a one-row :meth:`compute` gather, leading axis dropped)."""
        return tree_map(lambda v: v[0], self.compute(keys=[int(key)]))

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        raise TorchMetricsUserError(
            "KeyedMetric has no per-batch forward value: a mixed-tenant batch has one"
            " value PER KEY, not per batch. Drive it with update(key_ids, ...) and read"
            " values with compute(keys=...)."
        )

    def reset(self) -> None:
        super().reset()
        self._seen_keys[:] = False
        self._active_count = 0

    def __repr__(self) -> str:
        return f"{type(self).__name__}({type(self._template).__name__}(), num_keys={self.num_keys}, strategy={self._strategy!r})"


class KeyedMetricCollection(MetricCollection):
    """Many keyed metrics, one ``update(key_ids, ...)`` call, one shared tenant axis.

    Takes what :class:`~torchmetrics_tpu_torch.collections.MetricCollection` takes (a metric, a
    sequence or a dict of them, positional extras, nested collections) and wraps every member in a
    :class:`KeyedMetric` over the shared ``num_keys``; keyed members pass through when their
    ``num_keys`` matches, and a nested collection becomes a keyed collection whose members are
    flattened into this one. Unnamed members register under their template's class name. The
    dict-like surface (``keys``, ``items``, ``values``, ``persistent``, ``to``, ``set_dtype``, ...) is
    :class:`~torchmetrics_tpu_torch.collections.MetricCollection`'s.

    Example:
        >>> import numpy as np
        >>> from torchmetrics_tpu_torch.aggregation import MaxMetric, SumMetric
        >>> from torchmetrics_tpu_torch.keyed import KeyedMetricCollection
        >>> kc = KeyedMetricCollection([SumMetric(device="cpu"), MaxMetric(device="cpu")], num_keys=3)
        >>> kc.update(np.array([0, 1, 0]), np.array([1.0, 5.0, 2.0]))
        >>> {k: v.tolist() for k, v in sorted(kc.compute(keys=[0, 1]).items())}
        {'MaxMetric': [2.0, 5.0], 'SumMetric': [3.0, 5.0]}
    """

    def __init__(
        self,
        metrics: Union[Metric, MetricCollection, Sequence, Dict[str, Any]],
        *additional_metrics: Metric,
        num_keys: int,
        strategy: str = "auto",
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, list] = True,
        **keyed_kwargs: Any,
    ) -> None:
        self.num_keys = int(num_keys)

        def wrap(m: Any) -> Any:
            if isinstance(m, KeyedMetric):
                if m.num_keys != self.num_keys:
                    raise ValueError(
                        f"KeyedMetricCollection(num_keys={self.num_keys}) cannot hold a"
                        f" KeyedMetric with num_keys={m.num_keys}"
                    )
                return m
            if isinstance(m, MetricCollection):
                return KeyedMetricCollection(dict(m.items(keep_base=True, copy_state=False)),
                                             num_keys=self.num_keys, strategy=strategy, **keyed_kwargs)
            return KeyedMetric(m, self.num_keys, strategy=strategy, **keyed_kwargs)

        rest: list = []
        if isinstance(metrics, dict):
            if additional_metrics:
                raise ValueError(
                    f"Received extra positional arguments {additional_metrics} alongside a"
                    f" dict of metrics; name every metric in the dict instead."
                )
            named = {name: wrap(m) for name, m in metrics.items()}
        else:
            if isinstance(metrics, Sequence) and not isinstance(metrics, (str, bytes)):
                wrapped = [wrap(m) for m in (*metrics, *additional_metrics)]
            else:
                wrapped = [wrap(metrics), *(wrap(m) for m in additional_metrics)]
            # unnamed members register under their template's class name; nested collections keep
            # their members' names (JAX ``keyed/engine.py:443-455``)
            named = {}
            for w in wrapped:
                if not isinstance(w, KeyedMetric):
                    rest.append(w)
                    continue
                name = type(w.template).__name__
                if name in named:
                    raise ValueError(f"Encountered two metrics both named {name}")
                named[name] = w
        super().__init__(named, prefix=prefix, postfix=postfix, compute_groups=compute_groups)
        for coll in rest:
            self.add_metrics(coll)

    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        raise TorchMetricsUserError(
            "KeyedMetricCollection has no per-batch forward value — use"
            " update(key_ids, ...) + compute(keys=...)."
        )

    def compute(self, keys: Optional[Any] = None) -> Dict[str, Any]:
        """Per-key values for every member; ``keys`` gathers lazily (see ``KeyedMetric.compute``)."""
        if keys is None:
            return super().compute()
        self._compute_groups_create_state_ref()
        return self._finalize_result({name: m.compute(keys=keys) for name, m in self._modules.items()})
