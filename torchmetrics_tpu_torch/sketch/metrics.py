"""Standalone sketch metrics: streaming quantiles and histograms in a fixed state (counterpart of
``torchmetrics_tpu/sketch/metrics.py``).

``StreamingQuantile`` keeps the KLL compactor (``sketch/kll.py``) where ``CatMetric`` and a quantile
at compute would keep every sample; its reduction is the sketch merge, so sync folds the world's
partial sketches in rank order instead of gathering samples. ``StreamingHistogram`` keeps one
``(bins,)`` float32 count vector, updated by one launch of kernel K2 (``hist_pair``) per batch.
"""
from __future__ import annotations

from typing import Any, Sequence, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.sketch import hist as _hist
from torchmetrics_tpu_torch.sketch import kll as _kll
from torchmetrics_tpu_torch.sketch.state import hist_spec, kll_spec, register_sketch_state


class StreamingQuantile(Metric):
    """Streaming quantile estimate over an unbounded value stream, in a fixed state.

    The state is a ``(levels, capacity + 2)`` KLL compactor, whose rank error is bounded by the
    registered spec's ``error_bound`` (0.02·n at the default capacity of 128). The update is one
    static program with no read of the device, so it runs on every dispatch tier, and the state
    equals the JAX package's bit for bit. ``forward`` returns the batch's own quantile.

    Example:
        >>> import numpy as np
        >>> from torchmetrics_tpu_torch.sketch import StreamingQuantile
        >>> metric = StreamingQuantile(q=0.5, device="cpu")
        >>> metric.update(np.arange(1, 101, dtype=np.float32))
        >>> bool(abs(float(metric.compute()) - 50.0) <= 3.0)
        True
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False
    #: an update-only stream: ``update`` takes the graph tier (one replay a batch on the card)
    fast_update = True
    #: KLL does not decompose under segment reductions: the keyed engine takes its vmap strategy
    keyed_decomposable = False

    def __init__(
        self,
        q: Union[float, Sequence[float]] = 0.5,
        capacity: int = _kll.DEFAULT_CAPACITY,
        levels: int = _kll.DEFAULT_LEVELS,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        qs = (q,) if isinstance(q, (int, float)) else tuple(q)
        if not qs or not all(0.0 <= float(x) <= 1.0 for x in qs):
            raise ValueError(f"quantile probabilities must lie in [0, 1], got {qs}")
        self.q = tuple(float(x) for x in qs)
        self._scalar_q = isinstance(q, (int, float))
        # the probabilities live on the device, so that a compute copies nothing from the host
        self._q = torch.tensor(self.q, dtype=torch.float32, device=self.device)
        register_sketch_state(self, "sketch", kll_spec(capacity=capacity, levels=levels))

    def _update(self, state, values: Tensor):
        return {"sketch": _kll.kll_update(state["sketch"], values.reshape(-1))}

    def _compute(self, state) -> Tensor:
        out = _kll.kll_quantiles(state["sketch"], self._q)
        return out[0] if self._scalar_q else out

    @property
    def total_count(self) -> Tensor:
        """Exact weighted sample count folded so far (compaction conserves weight)."""
        return _kll.kll_count(self._state.tensors["sketch"])

    def to(self, device) -> "StreamingQuantile":
        super().to(device)
        self._q = self._q.to(self.device)
        return self


class StreamingHistogram(Metric):
    """Fixed-bin streaming histogram over ``[lo, hi)``; mass outside the range clips into the edge
    buckets. The state is one ``(bins,)`` float32 vector merged by sum; ``compute`` returns it.

    Example:
        >>> import numpy as np
        >>> from torchmetrics_tpu_torch.sketch import StreamingHistogram
        >>> metric = StreamingHistogram(bins=4, device="cpu")
        >>> metric.update(np.array([0.1, 0.2, 0.9, 2.0], dtype=np.float32))
        >>> metric.compute().tolist()
        [2.0, 0.0, 1.0, 1.0]
    """

    is_differentiable = False
    higher_is_better = None
    full_state_update = False
    #: an update-only stream: ``update`` takes the graph tier (one replay a batch on the card)
    fast_update = True

    def __init__(self, bins: int = 64, lo: float = 0.0, hi: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not hi > lo:
            raise ValueError(f"histogram range must satisfy hi > lo, got [{lo}, {hi})")
        self.bins = int(bins)
        self.lo = float(lo)
        self.hi = float(hi)
        # the range's width as a device tensor: CUDA divides by a host scalar as a product with its
        # reciprocal, which moves a value on a bucket edge; by a tensor it divides, as the CPU and JAX do
        self._width = torch.tensor(self.hi - self.lo, dtype=torch.float32, device=self.device)
        register_sketch_state(self, "hist", hist_spec(bins=self.bins))

    def _update(self, state, values: Tensor):
        values = values.reshape(-1).to(torch.float32)
        unit = (values - self.lo) / self._width
        zeros = torch.zeros_like(unit)
        new_p, _ = _hist.hist_update_pair(state["hist"], torch.zeros_like(state["hist"]), torch.clamp(unit, 0.0, 1.0),
                                          torch.ones_like(unit), zeros)
        return {"hist": new_p}

    def _compute(self, state) -> Tensor:
        return state["hist"]

    def to(self, device) -> "StreamingHistogram":
        super().to(device)
        self._width = self._width.to(self.device)
        return self

    @property
    def edges(self) -> np.ndarray:
        """Bucket edges implied by (bins, lo, hi): host numpy, never a device value."""
        return np.linspace(self.lo, self.hi, self.bins + 1, dtype=np.float32)
