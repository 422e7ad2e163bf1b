"""Sketch states: fixed-shape mergeable accumulators registered through ``add_state``
(counterpart of ``torchmetrics_tpu/sketch/state.py``).

A sketch state is an ordinary tensor state whose reduction is a merge, plus a :class:`SketchSpec`
that pins its kind, shape parameters and documented error bound. Three kinds, as in the JAX
package: ``"kll"`` (the quantile compactor, merged by the callable :func:`kll_merge_stacked`, which
sync applies to the world stacked in rank order), ``"countmin"`` and ``"hist"`` (both merged by
``"sum"``). :func:`note_update` feeds the telemetry counters (``sketch.merges``,
``sketch.compactions``, ``sketch.state_bytes_saved``) after each update, as the JAX package's engine
does. The packed wire codec (:func:`sketch_wire_bytes`) needs the compressed sync, which is not
ported yet (ROADMAP.md, queue A, item 9): it raises ``NotImplementedError``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from torch import Tensor

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.sketch import countmin as _cm
from torchmetrics_tpu_torch.sketch import hist as _hist
from torchmetrics_tpu_torch.sketch import kll as _kll

#: metric classes that offer a sketch twin for their unbounded ``cat`` state (``state.py:38``)
SKETCH_EQUIVALENTS = frozenset({
    "BinaryPrecisionRecallCurve",
    "MulticlassPrecisionRecallCurve",
    "MultilabelPrecisionRecallCurve",
    "RetrievalMetric",
})


@dataclass(frozen=True)
class SketchSpec:
    """Descriptor of one sketch state: kind, shape parameters and documented error bound."""

    kind: str
    params: Dict[str, Optional[int]] = field(default_factory=dict)
    error_bound: float = 0.0
    reduce_fx: Any = "sum"

    def init(self) -> Tensor:
        if self.kind == "kll":
            return _kll.kll_init(self.params["capacity"], self.params["levels"])
        if self.kind == "countmin":
            return _cm.cm_init(self.params["depth"], self.params["width"])
        if self.kind == "hist":
            return _hist.hist_init(self.params["bins"], self.params.get("classes"))
        raise ValueError(f"unknown sketch kind {self.kind!r}")

    def state_bytes(self) -> int:
        if self.kind == "kll":
            return _kll.kll_state_bytes(self.params["capacity"], self.params["levels"])
        if self.kind == "countmin":
            return _cm.cm_state_bytes(self.params["depth"], self.params["width"])
        return _hist.hist_state_bytes(self.params["bins"], self.params.get("classes")) // 2

    def describe(self) -> Dict[str, Any]:
        """Descriptor payload of plain JSON-able scalars."""
        return {
            "kind": self.kind,
            "params": {k: int(v) for k, v in self.params.items() if v is not None},
            "error_bound": float(self.error_bound),
        }

    @property
    def wire_kind(self) -> str:
        """The packed wire codec of this sketch on the compressed sync path: ``"kll"`` or ``"counts"``."""
        return "kll" if self.kind == "kll" else "counts"


def kll_spec(capacity: int = _kll.DEFAULT_CAPACITY, levels: int = _kll.DEFAULT_LEVELS) -> SketchSpec:
    """KLL quantile sketch spec; its merge is the capturable stacked compactor fold."""
    return SketchSpec(
        kind="kll",
        params={"capacity": int(capacity), "levels": int(levels)},
        error_bound=_kll.DEFAULT_RANK_ERROR * (_kll.DEFAULT_CAPACITY / capacity),
        reduce_fx=_kll.kll_merge_stacked,
    )


def countmin_spec(depth: int = _cm.DEFAULT_DEPTH, width: int = _cm.DEFAULT_WIDTH) -> SketchSpec:
    return SketchSpec(
        kind="countmin",
        params={"depth": int(depth), "width": int(width)},
        error_bound=_cm.cm_error_bound(width),
        reduce_fx="sum",
    )


def hist_spec(bins: int = _hist.DEFAULT_BINS, classes: Optional[int] = None) -> SketchSpec:
    return SketchSpec(
        kind="hist",
        params={"bins": int(bins), "classes": None if classes is None else int(classes)},
        error_bound=_hist.auroc_error_bound(bins),
        reduce_fx="sum",
    )


def register_sketch_state(metric: Any, name: str, spec: SketchSpec) -> None:
    """Register ``name`` on ``metric`` as a sketch state: ``add_state`` with the spec's default and
    merge reduction, plus the descriptor that :func:`sketch_descriptor` reports."""
    metric.add_state(name, spec.init(), dist_reduce_fx=spec.reduce_fx)
    metric.__dict__.setdefault("_sketch_specs", {})[name] = spec
    obs.telemetry.counter("sketch.states_registered").inc()


def sketch_descriptor(metric: Any) -> Optional[Dict[str, Any]]:
    """Per-state sketch descriptors, or None for a metric without sketch states."""
    specs = metric.__dict__.get("_sketch_specs")
    if not specs:
        return None
    return {name: spec.describe() for name, spec in specs.items()}


def sketch_state_bytes(metric: Any) -> int:
    """Total fixed sketch-state footprint of ``metric`` in bytes."""
    specs = metric.__dict__.get("_sketch_specs") or {}
    total = 0
    for name in specs:
        tensor = metric._tensors.get(name)
        total += tensor.numel() * tensor.element_size() if tensor is not None else 0
    return total


def sketch_wire_kinds(metric: Any) -> Optional[Dict[str, str]]:
    """``{state_name: kind}`` wire descriptors of ``metric``'s sketch states, or None for a metric
    without sketch states."""
    specs = metric.__dict__.get("_sketch_specs")
    if not specs:
        return None
    return {name: spec.kind for name, spec in specs.items()}


def sketch_wire_bytes(metric: Any) -> int:
    """The packed wire footprint of the sketch states: needs the compressed sync codec."""
    raise NotImplementedError(
        "sketch_wire_bytes needs the compressed sync codec (parallel/compress.py), which is not ported to"
        " torchmetrics_tpu_torch yet (ROADMAP.md, queue A, item 9); sketch_state_bytes gives the raw footprint"
    )


def _size_and_itemsize(v: Any) -> Optional[Tuple[int, int]]:
    """Element count and item size of a tensor or array argument, from its metadata only."""
    if isinstance(v, Tensor):
        return v.numel(), v.element_size()
    size = getattr(v, "size", None)
    if size is None or callable(size):
        return None
    return int(size), int(getattr(getattr(v, "dtype", None), "itemsize", 4) or 4)


def note_update(metric: Any, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> None:
    """Host-side telemetry of one sketch-metric update (JAX ``state.py:177-202``), from the
    arguments' shapes and dtypes, never their values: one merge per sketch state, the statically
    known compaction stages of a KLL state's bulk pre-compaction, and the bytes a ``cat`` twin
    would have appended instead."""
    specs = metric.__dict__.get("_sketch_specs") or {}
    if not specs:
        return
    batch_elems = 0
    batch_bytes = 0
    for v in list(args) + list(kwargs.values()):
        sized = _size_and_itemsize(v)
        if sized is not None:
            batch_elems = max(batch_elems, sized[0])
            batch_bytes += sized[0] * sized[1]
    compactions = 0
    for spec in specs.values():
        if spec.kind == "kll" and batch_elems:
            cap = spec.params["capacity"]
            # the halvings of the bulk pre-compaction (kll._bulk_fragments)
            compactions += max(0, math.ceil(math.log2(max(batch_elems, 1) / cap))) if batch_elems > cap else 0
    obs.telemetry.counter("sketch.merges").inc(len(specs))
    if compactions:
        obs.telemetry.counter("sketch.compactions").inc(compactions)
    if batch_bytes:
        obs.telemetry.counter("sketch.state_bytes_saved").inc(batch_bytes)
