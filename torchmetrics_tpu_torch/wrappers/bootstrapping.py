"""BootStrapper (counterpart of ``torchmetrics_tpu/wrappers/bootstrapping.py``; reference
``src/torchmetrics/wrappers/bootstrapping.py:54``)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.wrappers.abstract import WrapperMetric


def _bootstrap_sampler(size: int, sampling_strategy: str = "poisson", rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Indices along dim 0 resampled with replacement, on the host (reference ``bootstrapping.py:31-53``,
    JAX ``bootstrapping.py:13-21``): the same ``RandomState`` stream as the JAX package's."""
    rng = rng or np.random
    if sampling_strategy == "poisson":
        n = rng.poisson(1, size=size)
        return np.repeat(np.arange(size), n)
    if sampling_strategy == "multinomial":
        return rng.randint(0, size, size=size)
    raise ValueError("Unknown sampling strategy")


class BootStrapper(WrapperMetric):
    """Bootstrapped estimates of any metric (reference ``bootstrapping.py:54``).

    ``num_bootstraps`` copies of the metric each take a resample of every batch. The resamples are
    drawn on the host from a ``np.random.RandomState(seed)``, copy by copy in the JAX package's
    order, so one ``seed`` gives the JAX package's resamples; each ``update`` sends all copies'
    indices to the device in one transfer. ``reset`` restarts the stream of a seeded instance.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.1, 0.4, 0.35, 0.8])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> from torchmetrics_tpu_torch.classification import BinaryAccuracy
        >>> from torchmetrics_tpu_torch.wrappers import BootStrapper
        >>> metric = BootStrapper(BinaryAccuracy(device="cpu"), num_bootstraps=4, seed=0)
        >>> metric.update(preds, target)
        >>> {k: round(float(v), 4) for k, v in sorted(metric.compute().items())}
        {'mean': 0.8681, 'std': 0.1049}
    """

    full_state_update = True

    def __init__(
        self,
        base_metric: Metric,
        num_bootstraps: int = 10,
        mean: bool = True,
        std: bool = True,
        quantile: Optional[Union[float, Sequence[float]]] = None,
        raw: bool = False,
        sampling_strategy: str = "poisson",
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        if not isinstance(base_metric, Metric):
            raise ValueError(
                f"Expected base metric to be an instance of torchmetrics_tpu_torch.Metric but received {base_metric}"
            )
        kwargs.setdefault("device", base_metric.device)
        super().__init__(**kwargs)
        self.metrics = [base_metric.clone() for _ in range(num_bootstraps)]
        self.num_bootstraps = num_bootstraps
        self.mean = mean
        self.std = std
        self.quantile = quantile
        self.raw = raw
        allowed_sampling = ("poisson", "multinomial")
        if sampling_strategy not in allowed_sampling:
            raise ValueError(
                f"Expected argument ``sampling_strategy`` to be one of {allowed_sampling}"
                f" but received {sampling_strategy}"
            )
        self.sampling_strategy = sampling_strategy
        self.seed = seed
        self._rng = np.random.RandomState(seed)

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Resample the inputs for each copy, then update it (reference ``bootstrapping.py:124``)."""
        args, kwargs = self._coerce(args, kwargs)
        sizes = [a.shape[0] for a in (*args, *kwargs.values()) if isinstance(a, Tensor) and a.ndim > 0]
        if not sizes:
            raise ValueError("None of the input contained any tensor, so no sampling could be done")
        size = sizes[0]
        samples = [_bootstrap_sampler(size, self.sampling_strategy, self._rng) for _ in range(self.num_bootstraps)]
        lengths = [len(s) for s in samples]
        indices = torch.from_numpy(np.concatenate(samples).astype(np.int64)).to(self.device).split(lengths)
        for metric, sample_idx in zip(self.metrics, indices):
            if sample_idx.numel() == 0:
                continue
            new_args = tuple(self._take(a, sample_idx) for a in args)
            new_kwargs = {k: self._take(v, sample_idx) for k, v in kwargs.items()}
            metric.update(*new_args, **new_kwargs)
        self._update_count += 1
        self._update_called = True

    @staticmethod
    def _take(x: Any, idx: Tensor) -> Any:
        if isinstance(x, Tensor) and x.ndim > 0:
            return x.index_select(0, idx.to(x.device))
        return x

    def compute(self) -> Dict[str, Any]:
        """Mean, std (``correction=1``), quantiles (linear) and raw values over the copies (reference
        ``bootstrapping.py:147``)."""
        computed_vals = torch.stack([torch.as_tensor(m.compute()) for m in self.metrics], dim=0)
        output_dict = {}
        if self.mean:
            output_dict["mean"] = torch.mean(computed_vals, dim=0)
        if self.std:
            output_dict["std"] = torch.std(computed_vals, dim=0, correction=1)
        if self.quantile is not None:
            q = torch.as_tensor(self.quantile, dtype=computed_vals.dtype, device=computed_vals.device)
            output_dict["quantile"] = torch.quantile(computed_vals, q, dim=0)
        if self.raw:
            output_dict["raw"] = computed_vals
        return output_dict

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self.update(*args, **kwargs)
        return self.compute()

    def reset(self) -> None:
        for m in self.metrics:
            m.reset()
        if self.seed is not None:
            self._rng = np.random.RandomState(self.seed)  # reset() restarts the reproducible stream
        super().reset()
