"""MetricCollection: many metrics, one call, shared state through compute groups.

Counterpart of ``torchmetrics_tpu/collections.py`` (reference ``collections.py:34``): compute
groups formed after the first call by state equality (``:607-653``), leader-only update with the
leader's states aliased to the members (``:655-684``), the group forward of ``:115-307``, in which
one update per group and step feeds every member's batch value (one CUDA graph per group and
input signature on the card), ``update_batches`` (``:465``), ``sweep_fn`` (``:497``), ``buffered``
(``:309``), ``state_dict`` / ``load_state_dict`` (``:857``), ``world_consistent`` (``:427``), and the
dict-like surface: positional extras and nested collections, flattened with their prefix and postfix
(``:713-781``), ``keys`` / ``items`` / ``values`` / ``__getitem__`` / ``__iter__`` / ``__contains__``
(``:798-824``), ``persistent``, ``to``, ``set_dtype`` (``:853-899``), ``keyed`` (``:362``) and
``__repr__`` (``:906``).

Sync: ``compute`` runs each member's ``compute``, which syncs that member's state and puts it back
before the next member syncs (``:563``). The members of a compute group hold the leader's tensors in
dicts of their own, so a member's synced state never reaches the next member, which syncs the
local state again.

Telemetry: a group's fused forward is attributed to its leader (JAX ``collections.py:157-166``):
``group_forward_calls``, one dispatch and one ``group_forward`` span per group and step.
:attr:`MetricCollection.telemetry` sums the members' snapshots.
"""
from __future__ import annotations

from collections import OrderedDict
from copy import deepcopy
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.metric import Metric, _fold
from torchmetrics_tpu_torch.ops import dispatch as _dispatch
from torchmetrics_tpu_torch.parallel.sync import FULL, LOCAL, QUORUM, as_consistency
from torchmetrics_tpu_torch.utils.data import allclose
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn


def _flatten_dict(x: Dict) -> Tuple[Dict, bool]:
    """Flatten one level of nested dict values, and report whether two keys collided
    (``torchmetrics_tpu/collections.py:32``, reference ``utilities/data.py`` ``_flatten_dict``)."""
    new_dict: Dict = {}
    duplicates = False
    for key, value in x.items():
        for k, v in (value.items() if isinstance(value, dict) else ((key, value),)):
            if k in new_dict:
                duplicates = True
            new_dict[k] = v
    return new_dict, duplicates


class MetricCollection:
    """Dict of metrics sharing one ``update`` / ``forward`` / ``compute`` call (reference ``collections.py:34``).

    ``compute_groups=True`` groups the members whose states are equal after the first call;
    a list of lists of member names fixes the groups instead; ``False`` turns grouping off.
    """

    def __init__(
        self,
        metrics: Union[Metric, "MetricCollection", Sequence, Dict[str, Any]],
        *additional_metrics: Metric,
        prefix: Optional[str] = None,
        postfix: Optional[str] = None,
        compute_groups: Union[bool, List[List[str]]] = True,
    ) -> None:
        self._modules: "OrderedDict[str, Metric]" = OrderedDict()
        self.prefix = self._check_arg(prefix, "prefix")
        self.postfix = self._check_arg(postfix, "postfix")
        self._enable_compute_groups = compute_groups
        self._groups_checked = False
        self._groups: Dict[int, List[str]] = {}
        self.add_metrics(metrics, *additional_metrics)

    # ------------------------------------------------------------------- calls
    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Call ``forward`` on every metric and return the batch values by name.

        Once groups are formed, each group runs one update of its leader on a default state,
        evaluates every member's compute on that batch state, and merges it into the leader's
        state: on the card, one graph replay per group. A group with a ``full_state_update``
        member runs per metric. The first call runs per metric, then forms the groups.
        """
        if self._groups_checked:
            return self._finalize_result(self._forward_groups(*args, **kwargs))
        result = {name: m(*args, **m._filter_kwargs(**kwargs)) for name, m in self._modules.items()}
        self._form_groups()
        return self._finalize_result(result)

    def _forward_groups(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        result: Dict[str, Any] = {}
        for cg in self._groups.values():
            members = [self._modules[name] for name in cg]
            if any(m.full_state_update for m in members):
                # the batch value needs each member's own update (reference collections.py:122)
                _dispatch.STATS.note_fallback(members[0], "group_forward", "group_not_fusable")
                result.update((name, m(*args, **m._filter_kwargs(**kwargs))) for name, m in zip(cg, members))
                continue
            leader = members[0]
            f_args, f_kwargs = leader._coerce(args, leader._filter_kwargs(**kwargs))
            if leader._should_validate():
                leader._validate(*f_args, **f_kwargs)
            # k metrics in the group, one fused step, attributed to the leader
            obs.bump(leader, "group_forward_calls")
            with obs.metric_span(leader, "group_forward"):
                values = leader._fused_forward(f_args, f_kwargs, [m._compute for m in members], tuple(map(id, members)))
            result.update(zip(cg, values))
        self._compute_groups_create_state_ref()
        return result

    def __call__(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        return self.forward(*args, **kwargs)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Update every metric; once groups are formed, only each group's leader (reference ``collections.py:200-236``)."""
        if self._groups_checked:
            for cg in self._groups.values():
                leader = self._modules[cg[0]]
                leader.update(*args, **leader._filter_kwargs(**kwargs))
            self._compute_groups_create_state_ref()
            return
        for m in self._modules.values():
            m.update(*args, **m._filter_kwargs(**kwargs))
        self._form_groups()

    def update_batches(self, *args: Any, **kwargs: Any) -> None:
        """Fold a stack of batches into every metric, one ``update_batches`` per compute group
        (reference ``collections.py:465``). The groups are formed from the first batch."""
        if self._enable_compute_groups and not self._groups_checked:
            self.update(*(a[0] for a in args), **{k: v[0] for k, v in kwargs.items()})
            args, kwargs = tuple(a[1:] for a in args), {k: v[1:] for k, v in kwargs.items()}
            if (args[0] if args else next(iter(kwargs.values()))).shape[0] == 0:
                return
        if self._groups_checked:
            for cg in self._groups.values():
                leader = self._modules[cg[0]]
                leader.update_batches(*args, **leader._filter_kwargs(**kwargs))
            self._compute_groups_create_state_ref()
        else:  # compute groups disabled: every metric folds the stack itself
            for m in self._modules.values():
                m.update_batches(*args, **m._filter_kwargs(**kwargs))

    def sweep_fn(self) -> Callable[..., Dict[str, Any]]:
        """A ``(*stacked_args, **stacked_kwargs) -> {name: value}`` function (reference
        ``collections.py:497``).

        It folds a stack of batches (leading axis ``n_batches``) into fresh default states, one
        fold per compute group, then runs every member's compute on the final state. The
        collection's own state is never touched. On the card each call is one graph replay (one
        capture per stack signature). It needs formed compute groups (run one ``update`` or
        ``forward`` first) and members whose update and compute can be captured (tensor states).
        """
        if self._enable_compute_groups and not self._groups_checked:
            raise TorchMetricsUserError("sweep_fn requires formed compute groups — run one `update`/`forward` first.")
        member_lists = list(self._groups.values()) if self._enable_compute_groups else [[n] for n in self._modules]
        groups = []
        for cg in member_lists:
            members = [(name, self._modules[name]) for name in cg]
            leader = members[0][1]
            fusable = (not leader._lists and leader.scan_update and leader.jit_update
                       and all(m.jit_compute for _, m in members))
            if not fusable:
                raise TorchMetricsUserError(
                    f"sweep_fn: metric {cg[0]!r} is not scan-fusable (list states or host-side update/compute)."
                )
            groups.append((leader, members))
        first = groups[0][0]
        cache = _dispatch.GraphCache()
        obs.telemetry.counter("collection.sweep_fn.built").inc()

        def fold(*args: Any, **kwargs: Any) -> Dict[str, Any]:
            result: Dict[str, Any] = {}
            for leader, members in groups:
                final = _fold(leader._update, leader._default_state(), args, leader._filter_kwargs(**kwargs))
                for name, m in members:
                    result[name] = m._squeeze_if_scalar(m._compute(final))
            return result

        def build(s_args: tuple, s_kwargs: dict):
            # the sweep starts from the defaults and commits nothing: the collection's state stays
            return (lambda: (fold(*s_args, **s_kwargs), {})), (lambda new_state: None)

        def run(*args: Any, **kwargs: Any) -> Dict[str, Any]:
            obs.telemetry.counter("collection.sweep_fn.invocations").inc()
            obs.telemetry.event("collection.sweep_fn", cat="collection", args={"groups": len(groups)})
            args, kwargs = first._coerce(args, kwargs)
            values = _dispatch.MISS
            if all(leader._graph_gate("sweep_fn") for leader, _ in groups):
                try:
                    key = _dispatch.signature(args, kwargs)
                except TypeError:
                    _dispatch.STATS.note_fallback(first, "sweep_fn", "unhashable_argument")
                else:
                    values = cache.run(first, "sweep_fn", key, first.device, args, kwargs, build)
            if values is _dispatch.MISS:
                values = fold(*args, **kwargs)
            return self._finalize_result(values)

        return run

    def buffered(self, k: int) -> "_dispatch.BufferedUpdater":
        """Deferred accumulator over the whole collection (reference ``collections.py:309``): up to
        ``k`` ``update`` batches kept on the host, then folded by one :meth:`update_batches` call
        (one graph replay per compute group on the card). See :meth:`Metric.buffered`."""
        return _dispatch.BufferedUpdater(self, k)

    def windowed(self, window: int, advance_every: Optional[int] = None, **kwargs: Any) -> "MetricCollection":
        """A collection of sliding-window twins of every member (JAX ``collections.py:378``): each
        member cloned and wrapped in a :class:`~torchmetrics_tpu_torch.online.Windowed` ring under
        its name. This collection's own members stay untouched; compute groups are off, since
        ring bookkeeping must never be shared between members."""
        from torchmetrics_tpu_torch.online import Windowed

        return MetricCollection(
            {name: Windowed(m.clone(), window=window, advance_every=advance_every, **kwargs)
             for name, m in self._modules.items()},
            prefix=self.prefix, postfix=self.postfix, compute_groups=False,
        )

    @property
    def telemetry(self) -> Dict[str, Any]:
        """Every member's ``Metric.telemetry`` and the totals (JAX ``collections.py:691``). Group
        steps are attributed to each group's leader, so k members riding one step report one
        dispatch."""
        per = {name: m.telemetry for name, m in self._modules.items()}
        return {
            "metrics": per,
            "dispatches": sum(t["dispatches"] for t in per.values()),
            "retraces_total": sum(t["retraces_total"] for t in per.values()),
            "compute_groups": {i: list(v) for i, v in self._groups.items()},
        }

    def compute(self) -> Dict[str, Any]:
        self._compute_groups_create_state_ref()
        return self._finalize_result({name: m.compute() for name, m in self._modules.items()})

    def reset(self) -> None:
        for m in self._modules.values():
            m.reset()
        if self._groups_checked:
            self._compute_groups_create_state_ref()

    @property
    def world_consistent(self) -> Any:
        """The worst grade of the members' last syncs (JAX ``collections.py:427``): ``local`` if any
        member's is, else ``quorum`` if any member's is, else ``full``."""
        levels = {str(as_consistency(m.world_consistent)) for m in self._modules.values()}
        if "local" in levels:
            return LOCAL
        if "quorum" in levels:
            return QUORUM
        return FULL

    def clone(self, prefix: Optional[str] = None, postfix: Optional[str] = None) -> "MetricCollection":
        """Deep copy, with a new prefix or postfix where given (JAX ``collections.py:845``)."""
        mc = deepcopy(self)
        if prefix:
            mc.prefix = self._check_arg(prefix, "prefix")
        if postfix:
            mc.postfix = self._check_arg(postfix, "postfix")
        return mc

    def __len__(self) -> int:
        return len(self._modules)

    def _finalize_result(self, result: Dict[str, Any]) -> Dict[str, Any]:
        """Flatten dict-valued member results one level, then apply prefix/postfix naming
        (reference ``collections.py:314``, JAX ``collections.py:576``). A member's dict keys stand
        alone unless two keys of the flattened result collide; then every dict key is prefixed with
        its member's name, ``"<member>_<key>"``. The dict keys of a member taken from a nested
        collection carry that collection's prefix and postfix."""
        _, duplicates = _flatten_dict(result)
        flattened: Dict[str, Any] = {}
        for name, m in self._modules.items():
            res = result[name]
            if not isinstance(res, dict):
                flattened[name] = res
                continue
            nested = getattr(m, "_from_collection", False)
            for key, v in res.items():
                if duplicates:
                    stripped = name.replace(getattr(m, "prefix", "") or "", "").replace(getattr(m, "postfix", "") or "", "")
                    key = f"{stripped}_{key}"
                if nested and getattr(m, "prefix", None) is not None:
                    key = f"{m.prefix}{key}"
                if nested and getattr(m, "postfix", None) is not None:
                    key = f"{key}{m.postfix}"
                flattened[key] = v
        return {self._set_name(k): v for k, v in flattened.items()}

    # ----------------------------------------------------------- compute groups
    def _form_groups(self) -> None:
        if self._enable_compute_groups and not self._groups_checked:
            self._merge_compute_groups()
            self._compute_groups_create_state_ref()
            self._groups_checked = True

    def _merge_compute_groups(self) -> None:
        """Fixed-point pairwise merge of groups whose leaders hold equal states (reference ``collections.py:228``)."""
        merged = True
        while merged:
            merged = False
            for i, members_i in list(self._groups.items()):
                for j, members_j in list(self._groups.items()):
                    if i != j and self._equal_metric_states(self._modules[members_i[0]], self._modules[members_j[0]]):
                        self._groups[i].extend(self._groups.pop(j))
                        merged = True
                        break
                if merged:
                    break
        self._groups = dict(enumerate(self._groups.values()))
        obs.telemetry.counter("collection.compute_groups.formed").inc()
        obs.telemetry.event("collection.compute_groups", cat="collection",
                            args={"groups": {str(i): list(v) for i, v in self._groups.items()}})

    @staticmethod
    def _equal_metric_states(metric1: Metric, metric2: Metric) -> bool:
        """Shape and value equality of two metrics' full states (reference ``collections.py:265``)."""
        if not metric1._defaults or metric1._defaults.keys() != metric2._defaults.keys():
            return False
        state1, state2 = metric1.metric_state, metric2.metric_state
        for key in metric1._defaults:
            s1, s2 = state1[key], state2[key]
            if isinstance(s1, list) != isinstance(s2, list):
                return False
            if isinstance(s1, list):
                if len(s1) != len(s2) or not all(allclose(a, b) for a, b in zip(s1, s2)):
                    return False
            elif not allclose(s1, s2):
                return False
        return True

    def _compute_groups_create_state_ref(self) -> None:
        """Point every group member at its leader's states (reference ``collections.py:289``).

        On the graph tier the leader's tensors are its static buffers, which each replay writes
        in place, so the members see every step; on the eager tier they are replaced, and this
        call after each step points the members at the new ones. List states get a list of their
        own.
        """
        for cg in self._groups.values():
            leader = self._modules[cg[0]]
            for name in cg[1:]:
                member = self._modules[name]
                member._tensors.update(leader._tensors)
                for state, entries in leader._lists.items():
                    member._lists[state] = list(entries)
                member._update_count = leader._update_count
                member._update_called = leader._update_called
                if leader._computed is None:
                    member._computed = None

    @property
    def compute_groups(self) -> Dict[int, List[str]]:
        return self._groups

    # ------------------------------------------------------------- persistence
    def state_dict(self) -> Dict[str, Any]:
        """Every member's persistent states under ``"<name>."`` (reference ``collections.py:857``)."""
        destination: Dict[str, Any] = {}
        for name, m in self._modules.items():
            m.state_dict(destination=destination, prefix=f"{name}.")
        return destination

    def load_state_dict(self, state_dict: Dict[str, Any], strict: bool = True) -> None:
        """Restore every member from :meth:`state_dict`'s format. Members restore their own
        states, so formed groups are checked again on the next call (reference
        ``collections.py:885``); fixed groups are aliased to their leaders at once."""
        for name, m in self._modules.items():
            m.load_state_dict({k[len(name) + 1:]: v for k, v in state_dict.items() if k.startswith(f"{name}.")},
                              strict=strict)
        if isinstance(self._enable_compute_groups, list):
            self._compute_groups_create_state_ref()
        else:
            self._groups_checked = False

    def persistent(self, mode: bool = True) -> None:
        """Set the persistence of every member's states (JAX ``collections.py:853``)."""
        for m in self.values(copy_state=False):
            m.persistent(mode)

    def to(self, device: Any) -> "MetricCollection":
        """Move every member to ``device`` (JAX ``collections.py:890``); the groups' members are
        pointed at their leaders' moved states."""
        for m in self._modules.values():
            m.to(device)
        self._compute_groups_create_state_ref()
        return self

    def set_dtype(self, dst_type: Any) -> "MetricCollection":
        """Cast every member's float states to ``dst_type`` (JAX ``collections.py:895``)."""
        for m in self._modules.values():
            m.set_dtype(dst_type)
        self._compute_groups_create_state_ref()
        return self

    def keyed(self, num_keys: int, strategy: str = "auto") -> "MetricCollection":
        """A :class:`~torchmetrics_tpu_torch.keyed.KeyedMetricCollection` twin of this collection (JAX
        ``collections.py:362``): every member cloned and wrapped over a shared ``[num_keys, ...]``
        tenant axis. This collection's own members and states stay untouched."""
        from torchmetrics_tpu_torch.keyed import KeyedMetricCollection

        return KeyedMetricCollection(
            {name: m.clone() for name, m in self._modules.items()},
            num_keys=num_keys, strategy=strategy, prefix=self.prefix, postfix=self.postfix,
        )

    # -------------------------------------------------------------- dict-likes
    def _flatten_collection(self, name: Optional[str], coll: "MetricCollection") -> Iterator[Tuple[str, Metric]]:
        """A nested collection's members as (registration name, metric) pairs (JAX
        ``collections.py:713``, reference ``collections.py:414-424``): each under its renamed key,
        after ``name`` and an underscore where the collection came with a name, and tagged with the
        inner collection's prefix and postfix for the naming of its dict-valued results."""
        for key, member in coll.items(keep_base=False):
            member.prefix = coll.prefix
            member.postfix = coll.postfix
            member._from_collection = True
            yield (f"{name}_{key}" if name is not None else key, member)

    def add_metrics(self, metrics: Union[Metric, "MetricCollection", Sequence, Dict[str, Any]],
                    *additional_metrics: Metric) -> None:
        """Register a metric or a collection, a sequence of them (named by class; positional extras
        join it, and extras that are not metrics are dropped with a warning), or a dict of named
        ones (no extras). Nested collections are flattened (JAX ``collections.py:722-781``,
        reference ``collections.py:380-456``)."""
        if isinstance(metrics, (Metric, MetricCollection)):
            metrics = [metrics]
        if isinstance(metrics, dict):
            if additional_metrics:
                raise ValueError(
                    f"Received extra positional arguments {additional_metrics} alongside a dict of"
                    f" metrics {metrics}; name every metric in the dict instead."
                )
            pairs: List[Tuple[Optional[str], Any]] = [(name, metrics[name]) for name in sorted(metrics)]
        elif isinstance(metrics, Sequence) and not isinstance(metrics, (str, bytes)):
            dropped = [m for m in additional_metrics if not isinstance(m, (Metric, MetricCollection))]
            if dropped:
                rank_zero_warn(f"Ignoring extra non-Metric arguments {dropped}.")
            kept = [m for m in additional_metrics if isinstance(m, (Metric, MetricCollection))]
            pairs = [(None, m) for m in [*metrics, *kept]]
        else:
            raise ValueError(
                "Unknown input to MetricCollection. Expected, `Metric`, `MetricCollection` or `dict`/`sequence` of"
                f" the previous, but got {metrics}"
            )
        for name, metric in pairs:
            if isinstance(metric, MetricCollection):
                for key, member in self._flatten_collection(name, metric):
                    self._modules[key] = member
            elif isinstance(metric, Metric):
                key = name if name is not None else type(metric).__name__
                if name is None and key in self._modules:
                    raise ValueError(f"Encountered two metrics both named {key}")
                self._modules[key] = metric
            else:
                what = f"Value {metric} belonging to key {name}" if name is not None else f"Input {metric}"
                raise ValueError(f"{what} is not an instance of `Metric` or `MetricCollection`")
        self._init_compute_groups()

    def _init_compute_groups(self) -> None:
        """One group per member, to be merged after the next call, or the groups the caller fixed."""
        self._groups_checked = False
        if isinstance(self._enable_compute_groups, list):
            self._groups = dict(enumerate(self._enable_compute_groups))
            for group in self._groups.values():
                for name in group:
                    if name not in self._modules:
                        raise ValueError(
                            f"Input {name} in `compute_groups` argument does not match a metric in the"
                            f" collection. Please make sure that {self._enable_compute_groups} matches"
                            f" {list(self._modules)}"
                        )
            self._groups_checked = True
        elif self._enable_compute_groups:
            self._groups = {i: [name] for i, name in enumerate(self._modules)}
        else:
            self._groups = {}

    def _set_name(self, base: str) -> str:
        name = base if self.prefix is None else self.prefix + base
        return name if self.postfix is None else name + self.postfix

    def _to_renamed_ordered_dict(self) -> "OrderedDict[str, Metric]":
        return OrderedDict((self._set_name(k), v) for k, v in self._modules.items())

    # ``copy_state`` is taken for the JAX package's signatures, where it changes nothing either
    # (JAX ``collections.py:10``): the members of a group hold the leader's state tensors, and every
    # tensor handed to a caller (``metric_state``, ``state_dict``, ``compute``) is a copy.
    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __contains__(self, key: str) -> bool:
        return key in self._modules

    def keys(self, keep_base: bool = False) -> Iterable[str]:
        """The registration names, or with the prefix and postfix applied (JAX ``collections.py:807``)."""
        if keep_base:
            return self._modules.keys()
        return self._to_renamed_ordered_dict().keys()

    def items(self, keep_base: bool = False, copy_state: bool = True) -> Iterable[Tuple[str, Metric]]:
        self._compute_groups_create_state_ref()
        if keep_base:
            return self._modules.items()
        return self._to_renamed_ordered_dict().items()

    def values(self, copy_state: bool = True) -> Iterable[Metric]:
        self._compute_groups_create_state_ref()
        return self._modules.values()

    def __getitem__(self, key: str, copy_state: bool = True) -> Metric:
        self._compute_groups_create_state_ref()
        return self._modules[key]

    def __repr__(self) -> str:
        out = type(self).__name__ + "("
        if self.prefix:
            out += f"\n  prefix={self.prefix}"
        if self.postfix:
            out += f"\n  postfix={self.postfix}"
        for k, v in self._modules.items():
            out += f"\n  ({k}): {v!r}"
        return out + "\n)"

    @staticmethod
    def _check_arg(arg: Optional[str], name: str) -> Optional[str]:
        if arg is None or isinstance(arg, str):
            return arg
        raise ValueError(f"Expected input `{name}` to be a string, but got {type(arg)}")
