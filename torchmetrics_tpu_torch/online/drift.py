"""Drift detection: a windowed metric's state against a reference, alarmed through the SLO
burn-rate machinery (counterpart of ``torchmetrics_tpu/online/drift.py``).

Three detectors, all host-side float64 numpy over O(sketch) support points, as in the JAX
package:

- :class:`KsDrift`: the Kolmogorov-Smirnov distance between the current window's KLL sketch and
  a reference;
- :class:`PsiDrift`: the Population Stability Index over quantile-grid bins of the reference
  (rule of thumb: 0.1 drifting, 0.25 shifted);
- :class:`EwmaBand`: an EWMA control band over a scalar value stream (the emitted window values),
  scored in sigma units; its state is three floats.

A sketch reaches the detectors through one copy to the host (a CUDA tensor does not convert with
``np.asarray``). A reference may be a numpy array of samples, a tensor on any device, a KLL state
or a metric holding one. A :class:`DriftSpec` names a detector, a score threshold and a
multi-window burn policy; :class:`DriftMonitor` records each evaluation's score into a
``drift.<name>.score`` series and runs an :class:`~torchmetrics_tpu_torch.obs.slo.SloMonitor` over
it: a warning per transition into burning, ``slo.alarms`` / ``drift.alarms`` counters and a burn
gauge.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch import obs
from torchmetrics_tpu_torch.obs.slo import DEFAULT_WINDOWS, SloMonitor, SloSpec, SloStatus
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

__all__ = [
    "DriftDetector",
    "DriftMonitor",
    "DriftSpec",
    "EwmaBand",
    "KsDrift",
    "PsiDrift",
    "default_drift_specs",
]

#: PSI rule-of-thumb alarm threshold ("population has shifted")
DEFAULT_PSI_THRESHOLD = 0.25
#: KS-distance default alarm threshold
DEFAULT_KS_THRESHOLD = 0.15
#: PSI's clamp of an empty bin's mass
_PSI_EPS = 1e-6


# ---------------------------------------------------------------------------
# weighted-point plumbing (host numpy; sketches expose their support explicitly)
# ---------------------------------------------------------------------------

def _on_host(x: Any) -> Any:
    """A tensor copied to the host once (CPU tensors pass as they are); anything else as given."""
    return x.detach().cpu() if isinstance(x, Tensor) else x


def _metric_sketch_state(metric: Any, state: str) -> Any:
    """The named sketch state, merged over the ring for a windowed metric."""
    window_state = getattr(metric, "window_state", None)
    source = window_state() if callable(window_state) else metric.metric_state
    if state not in source:
        raise TorchMetricsUserError(
            f"{type(metric).__name__} has no state {state!r}; registered states are {sorted(source)}"
        )
    return source[state]


def _as_points(ref: Any, state: str = "sketch") -> Tuple[np.ndarray, np.ndarray]:
    """A reference as (values, weights) support points: a raw sample array (unit weights: the
    exact empirical distribution), a 2-D KLL sketch state, or a metric holding one
    (``StreamingQuantile`` or a ``Windowed`` wrapper of it)."""
    from torchmetrics_tpu_torch.sketch.kll import kll_weighted_points

    if hasattr(ref, "_state"):  # a Metric
        ref = _metric_sketch_state(ref, state)
    ref = _on_host(ref)
    if isinstance(ref, Tensor) and ref.ndim == 2:  # a KLL state (levels, capacity + 2)
        v, w = kll_weighted_points(ref)
        return v.numpy().astype(np.float64), w.numpy().astype(np.float64)
    arr = ref.numpy() if isinstance(ref, Tensor) else np.asarray(ref)
    if arr.ndim == 2:
        v, w = kll_weighted_points(torch.from_numpy(np.ascontiguousarray(arr, np.float32)))
        return v.numpy().astype(np.float64), w.numpy().astype(np.float64)
    values = arr.astype(np.float64).reshape(-1)
    return np.sort(values), np.ones(values.size, np.float64)


def _sorted_finite(values: np.ndarray, weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The finite, positively weighted points in ascending order (no sort where they already are:
    raw references and sketch supports arrive sorted)."""
    finite = np.isfinite(values) & (weights > 0)
    v, w = values[finite], weights[finite]
    if v.size > 1 and not bool(np.all(v[1:] >= v[:-1])):
        order = np.argsort(v, kind="stable")
        v, w = v[order], w[order]
    return v, w


def _cdf_at(values: np.ndarray, weights: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Weighted empirical CDF of (values, weights) evaluated at ``xs``."""
    v, w = _sorted_finite(values, weights)
    if v.size == 0:
        return np.zeros_like(xs, np.float64)
    cw = np.cumsum(w)
    idx = np.searchsorted(v, xs, side="right")
    cdf = np.where(idx > 0, cw[np.clip(idx - 1, 0, len(cw) - 1)], 0.0)
    return cdf / cw[-1]


def ks_distance_points(a: Tuple[np.ndarray, np.ndarray], b: Tuple[np.ndarray, np.ndarray]) -> float:
    """KS distance between two weighted empirical distributions (the host twin of
    ``sketch.kll.kll_ks_distance``): the largest CDF gap over the finite points of both supports.

    Both CDFs are read off one stable sort of the two supports together, each side's weights summed
    in its own order (the other side's points add zeros), at the last point of each run of equal
    values: the float64 sums the JAX package's per-point evaluation forms, in one sort of two sorted
    runs, where a search per point of a raw reference of many samples costs many times more.
    """
    vals = np.concatenate([a[0], b[0]]).astype(np.float64)
    keep = np.isfinite(vals)
    if not keep.any():
        return 0.0
    n_a = len(a[0])
    sides = []
    for lo, hi, (v, w) in ((0, n_a, a), (n_a, vals.size, b)):
        weights = np.zeros(vals.size)
        weights[lo:hi] = np.where(np.isfinite(v) & (w > 0), w, 0.0)
        sides.append(weights[keep])
    vals = vals[keep]
    order = np.argsort(vals, kind="stable")
    vals = vals[order]
    last = np.r_[vals[1:] != vals[:-1], True]  # the last point of each run of equal values
    cdfs = []
    for weights in sides:
        cw = np.cumsum(weights[order])
        cdfs.append(cw[last] / cw[-1] if cw[-1] > 0 else np.zeros(int(last.sum())))
    return float(np.max(np.abs(cdfs[0] - cdfs[1])))


def _psi_reference(ref: Tuple[np.ndarray, np.ndarray], bins: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The reference side of PSI: the interior edges of its quantile grid and its clamped bin masses
    (None for an empty reference). A detector computes it once for its fixed reference."""
    v, w = _sorted_finite(*ref)
    if v.size == 0:
        return None
    cw = np.cumsum(w)
    targets = np.linspace(0.0, 1.0, bins + 1)[1:-1] * cw[-1]
    edges = v[np.minimum(np.searchsorted(cw, targets, side="left"), v.size - 1)]
    p = np.diff(_cdf_at(*ref, edges), prepend=0.0, append=1.0)
    return edges, np.clip(p, _PSI_EPS, None)


def _psi_against(reference: Optional[Tuple[np.ndarray, np.ndarray]], cur: Tuple[np.ndarray, np.ndarray]) -> float:
    if reference is None:
        return 0.0
    edges, p = reference
    q = np.clip(np.diff(_cdf_at(*cur, edges), prepend=0.0, append=1.0), _PSI_EPS, None)
    return float(np.sum((q - p) * np.log(q / p)))


def psi_points(ref: Tuple[np.ndarray, np.ndarray], cur: Tuple[np.ndarray, np.ndarray], bins: int = 10) -> float:
    """Population Stability Index over quantile-grid bins of the reference (the host twin of
    ``sketch.kll.kll_psi``; masses clamped at 1e-6, so an empty bin costs a finite penalty)."""
    return _psi_against(_psi_reference(ref, bins), cur)


# ---------------------------------------------------------------------------
# detectors
# ---------------------------------------------------------------------------

class DriftDetector:
    """One drift score source: ``score()`` returns the current drift magnitude, or ``None`` when
    there is no evidence yet (empty window, warm-up). Host-side and deterministic."""

    def score(self) -> Optional[float]:
        raise NotImplementedError

    def state(self) -> Dict[str, float]:
        """Serialisable detector state (empty for stateless detectors)."""
        return {}

    def restore(self, state: Dict[str, float]) -> None:
        """Restore a :meth:`state` payload (no-op for stateless detectors)."""


def _window_points(metric: Any, state: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The metric's (window-merged) sketch as host points after one copy, None when it is empty."""
    from torchmetrics_tpu_torch.sketch.kll import kll_count

    sk = _on_host(_metric_sketch_state(metric, state))
    if float(kll_count(sk)) <= 0:
        return None  # an empty window: no evidence either way
    return _as_points(sk)


class _SketchDetector(DriftDetector):
    """A detector of ``metric``'s (window-merged) sketch state ``state_name`` against a fixed
    reference: :meth:`score_points` scores the window's host points, so that a monitor reads each
    watched window once per evaluation however many detectors share it."""

    metric: Any
    state_name: str

    def score_points(self, points: Tuple[np.ndarray, np.ndarray]) -> float:
        raise NotImplementedError

    def score(self) -> Optional[float]:
        points = _window_points(self.metric, self.state_name)
        return None if points is None else self.score_points(points)


class KsDrift(_SketchDetector):
    """KS distance between ``metric``'s (window-merged) KLL sketch and ``reference``: both sides
    fixed-size sketch supports, or the reference's raw samples."""

    def __init__(self, metric: Any, reference: Any, state: str = "sketch") -> None:
        self.metric = metric
        self.state_name = state
        self._ref = _as_points(reference, state)

    def score_points(self, points: Tuple[np.ndarray, np.ndarray]) -> float:
        return ks_distance_points(points, self._ref)


class PsiDrift(_SketchDetector):
    """PSI between ``metric``'s (window-merged) KLL sketch and ``reference`` over ``bins``
    reference-quantile bins."""

    def __init__(self, metric: Any, reference: Any, bins: int = 10, state: str = "sketch") -> None:
        if bins < 2:
            raise ValueError(f"PsiDrift needs bins >= 2, got {bins}")
        self.metric = metric
        self.state_name = state
        self.bins = int(bins)
        self._ref = _psi_reference(_as_points(reference, state), self.bins)

    def score_points(self, points: Tuple[np.ndarray, np.ndarray]) -> float:
        return _psi_against(self._ref, points)


class EwmaBand(DriftDetector):
    """EWMA control band over a scalar value stream: score = |x - ewma| in sigma units.

    Feed values with :meth:`observe` (each value is scored against the band BEFORE it is folded
    in, so a level shift cannot mask itself), or bind a ``metric`` whose scalar window value is
    read at every :meth:`score`. Warm-up observations score ``None``.
    """

    def __init__(self, metric: Any = None, alpha: float = 0.1, warmup: int = 5, min_sigma: float = 1e-9) -> None:
        if not (0.0 < alpha <= 1.0):
            raise ValueError(f"EwmaBand needs alpha in (0, 1], got {alpha}")
        self.metric = metric
        self.alpha = float(alpha)
        self.warmup = max(1, int(warmup))
        self.min_sigma = float(min_sigma)
        self._mean = 0.0
        self._var = 0.0
        self._n = 0

    def observe(self, value: float) -> Optional[float]:
        """Score ``value`` against the current band, then fold it into the EWMA."""
        value = float(value)
        if self._n >= self.warmup:
            sigma = max(np.sqrt(self._var), self.min_sigma)
            z = abs(value - self._mean) / sigma
        else:
            z = None
        a = self.alpha
        if self._n == 0:
            self._mean = value
        else:
            delta = value - self._mean
            self._mean += a * delta
            self._var = (1.0 - a) * (self._var + a * delta * delta)
        self._n += 1
        return z

    def score(self) -> Optional[float]:
        if self.metric is None:
            raise TorchMetricsUserError(
                "This EwmaBand has no bound metric: drive it with observe(value), or"
                " construct it with EwmaBand(metric=...)"
            )
        reader = getattr(self.metric, "window_values", None)
        value = reader() if callable(reader) else self.metric.compute()
        arr = np.asarray(_on_host(value))
        if arr.size != 1:
            raise TorchMetricsUserError(
                f"EwmaBand needs a scalar value stream; {type(self.metric).__name__} produced shape {arr.shape}"
            )
        return self.observe(float(arr.reshape(())))

    def state(self) -> Dict[str, float]:
        return {"mean": self._mean, "var": self._var, "n": float(self._n)}

    def restore(self, state: Dict[str, float]) -> None:
        self._mean = float(state["mean"])
        self._var = float(state["var"])
        self._n = int(state["n"])


# ---------------------------------------------------------------------------
# specs + monitor
# ---------------------------------------------------------------------------

@dataclass
class DriftSpec:
    """One drift objective: a detector, a score threshold (in the detector's units: KS distance,
    PSI nats, EWMA sigmas) and the burn-rate policy over the recorded score series."""

    name: str
    detector: DriftDetector
    threshold: float
    objective: float = 0.999
    windows: Tuple[Tuple[float, float], ...] = DEFAULT_WINDOWS
    description: str = ""

    def as_slo_spec(self) -> SloSpec:
        return SloSpec(
            name=self.name,
            series=f"drift.{self.name}.score",
            objective=self.objective,
            threshold=self.threshold,
            bad_when="above",
            windows=self.windows,
            description=self.description or f"drift score above {self.threshold:g} (docs/online.md)",
        )


@dataclass
class DriftStatus:
    """One drift evaluation: the raw score and the SLO burn verdict."""

    spec: DriftSpec
    score: Optional[float]
    slo: Optional[SloStatus]

    @property
    def drifting(self) -> bool:
        return bool(self.slo is not None and self.slo.burning)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.spec.name,
            "score": None if self.score is None else round(self.score, 6),
            "threshold": self.spec.threshold,
            "drifting": self.drifting,
            "slo": None if self.slo is None else self.slo.as_dict(),
        }


class DriftMonitor:
    """Evaluates drift specs through the SLO burn-rate machinery.

    Each :meth:`evaluate` call scores every detector, records the scores into ``drift.<name>.score``
    series and gauges, and runs the embedded :class:`SloMonitor` over them. ``now`` pins the clock
    for tests; production callers leave it None.
    """

    def __init__(self, specs: Sequence[DriftSpec] = (), registry: Any = None) -> None:
        self.specs: List[DriftSpec] = list(specs)
        self._tel = registry if registry is not None else obs.telemetry
        self._slo = SloMonitor([s.as_slo_spec() for s in self.specs], registry=self._tel)
        self._subscribers: List[Any] = []
        self._was_firing: set = set()

    def subscribe(self, fn: Any) -> "DriftMonitor":
        """Register ``fn(status, firing)`` to run on every alarm *transition*: into
        (``firing=True``) or out of (``firing=False``) the drifting state. Steady states do not call."""
        self._subscribers.append(fn)
        return self

    def watch(self, spec: DriftSpec) -> "DriftMonitor":
        self.specs.append(spec)
        self._slo.watch(spec.as_slo_spec())
        return self

    def evaluate(self, now: Optional[float] = None) -> List[DriftStatus]:
        scores: Dict[str, Optional[float]] = {}
        # each watched window is merged and copied to the host once, for all its sketch detectors
        windows: Dict[Tuple[int, str], Optional[Tuple[np.ndarray, np.ndarray]]] = {}
        for spec in self.specs:
            self._tel.counter("drift.evaluations").inc()
            detector = spec.detector
            if isinstance(detector, _SketchDetector):
                key = (id(detector.metric), detector.state_name)
                if key not in windows:
                    windows[key] = _window_points(detector.metric, detector.state_name)
                points = windows[key]
                s = None if points is None else detector.score_points(points)
            else:
                s = detector.score()
            scores[spec.name] = s
            if s is None:
                continue  # no evidence: the empty window cannot satisfy any burn
            self._tel.series(f"drift.{spec.name}.score").record(float(s), now=now)
            self._tel.gauge(f"drift.{spec.name}.score").set(float(s))
        statuses = {st.spec.name: st for st in self._slo.evaluate(now=now)}
        out: List[DriftStatus] = []
        for spec in self.specs:
            st = statuses.get(spec.name)
            if st is not None and st.burning:
                self._tel.counter("drift.alarms").inc()
                self._tel.counter(f"drift.alarms.{spec.name}").inc()
            out.append(DriftStatus(spec=spec, score=scores[spec.name], slo=st))
        for status in out:
            firing = status.drifting
            was = status.spec.name in self._was_firing
            if firing == was:
                continue  # steady state: subscribers see transitions only
            (self._was_firing.add if firing else self._was_firing.discard)(status.spec.name)
            for fn in self._subscribers:
                fn(status, firing)
        return out

    def drifting(self) -> List[str]:
        """Names of specs whose last evaluation fired."""
        return self._slo.burning()


def default_drift_specs(
    metric: Any,
    reference: Any,
    name: Optional[str] = None,
    ks_threshold: float = DEFAULT_KS_THRESHOLD,
    psi_threshold: float = DEFAULT_PSI_THRESHOLD,
    psi_bins: int = 10,
    windows: Tuple[Tuple[float, float], ...] = DEFAULT_WINDOWS,
) -> List[DriftSpec]:
    """The stock quality alarms of a served, windowed, sketch-backed metric: a KS-distance spec
    and a PSI spec, both comparing ``metric``'s (window-merged) KLL sketch with ``reference`` (a
    held-out sample array, a reference sketch state, or a warmed-up twin metric)."""
    base = name or f"{type(metric).__name__.lower()}-drift"
    return [
        DriftSpec(
            name=f"{base}-ks",
            detector=KsDrift(metric, reference),
            threshold=ks_threshold,
            windows=windows,
            description="KS distance of the live window vs the reference distribution",
        ),
        DriftSpec(
            name=f"{base}-psi",
            detector=PsiDrift(metric, reference, bins=psi_bins),
            threshold=psi_threshold,
            windows=windows,
            description="PSI of the live window vs the reference distribution",
        ),
    ]
