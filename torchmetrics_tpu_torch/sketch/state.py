"""Sketch states: fixed-shape mergeable accumulators registered through ``add_state``
(counterpart of ``torchmetrics_tpu/sketch/state.py``).

A sketch state is an ordinary tensor state whose reduction is a merge, plus a :class:`SketchSpec`
that pins its kind, shape parameters and documented error bound. The port carries the ``"hist"``
kind, the curve sketch. The KLL quantile and count-min sketches, their wire codecs and the
telemetry counters of the JAX package are not ported yet (ROADMAP.md, queue A, items 7 and 9).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from torch import Tensor

from torchmetrics_tpu_torch.sketch import hist as _hist

_NOT_PORTED = ("kll", "countmin")


@dataclass(frozen=True)
class SketchSpec:
    """Descriptor of one sketch state: kind, shape parameters and documented error bound."""

    kind: str
    params: Dict[str, Optional[int]] = field(default_factory=dict)
    error_bound: float = 0.0
    reduce_fx: Any = "sum"

    def __post_init__(self) -> None:
        if self.kind in _NOT_PORTED:
            raise NotImplementedError(
                f"sketch kind {self.kind!r} is not ported to torchmetrics_tpu_torch yet (ROADMAP.md, queue A,"
                " item 7); the port has the 'hist' curve sketch"
            )
        if self.kind != "hist":
            raise ValueError(f"unknown sketch kind {self.kind!r}")

    def init(self) -> Tensor:
        return _hist.hist_init(self.params["bins"], self.params.get("classes"))

    def state_bytes(self) -> int:
        return _hist.hist_state_bytes(self.params["bins"], self.params.get("classes")) // 2

    def describe(self) -> Dict[str, Any]:
        """Descriptor payload of plain JSON-able scalars."""
        return {
            "kind": self.kind,
            "params": {k: int(v) for k, v in self.params.items() if v is not None},
            "error_bound": float(self.error_bound),
        }


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
