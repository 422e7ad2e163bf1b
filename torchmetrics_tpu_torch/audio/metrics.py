"""Audio module metrics (counterpart of ``torchmetrics_tpu/audio/metrics.py``).

Every class keeps the JAX package's state design: a float32 sum of the per-sample values and a
float32 sample count, both ``sum``-reduced. The SNR family, SDR and PIT update on the graph tier
(``fast_update``; JAX's ``jit_update`` is True for them): their updates read nothing back from the
device and build no tensor from host data. PESQ, STOI and SRMR run on the host and step eagerly
(``jit_update = False``, ``scan_update = False``, as in JAX).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.audio.deps import (
    _require_pesq,
    _require_pystoi,
    perceptual_evaluation_speech_quality,
    short_time_objective_intelligibility,
)
from torchmetrics_tpu_torch.functional.audio.pit import permutation_invariant_training
from torchmetrics_tpu_torch.functional.audio.sdr import signal_distortion_ratio
from torchmetrics_tpu_torch.functional.audio.snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_distortion_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
    source_aggregated_signal_distortion_ratio,
)
from torchmetrics_tpu_torch.functional.audio.srmr import (
    _srmr_arg_validate,
    speech_reverberation_modulation_energy_ratio,
)
from torchmetrics_tpu_torch.metric import Metric

#: the base keywords that PIT keeps for itself; the rest go to ``metric_func`` (JAX ``metrics.py:247-262``,
#: with the port's ``device``)
_PIT_BASE_KEYWORDS = ("compute_on_cpu", "dist_sync_on_step", "process_group", "dist_sync_fn",
                      "distributed_available_fn", "sync_on_compute", "compute_with_cache", "device")


class _MeanOverSamplesMetric(Metric):
    """The per-sample values summed, and their count; the compute is the mean (JAX ``metrics.py:30``)."""

    full_state_update = False

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_metric", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _batch_values(self, preds: Tensor, target: Tensor) -> Tensor:
        raise NotImplementedError

    def _update(self, state: Dict[str, Tensor], preds: Tensor, target: Tensor) -> Dict[str, Tensor]:
        vals = self._batch_values(preds, target)
        return {"sum_metric": state["sum_metric"] + torch.sum(vals), "total": state["total"] + vals.numel()}

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        return state["sum_metric"] / state["total"]


class SignalNoiseRatio(_MeanOverSamplesMetric):
    """SNR (JAX ``metrics.py:54``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import SignalNoiseRatio
        >>> metric = SignalNoiseRatio(device="cpu")
        >>> metric.update(torch.tensor([2.5, 0.0, 2.0, 8.0]), torch.tensor([3.0, -0.5, 2.0, 7.0]))
        >>> print(f"{float(metric.compute()):.2f}")
        16.18
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def _batch_values(self, preds: Tensor, target: Tensor) -> Tensor:
        return signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)


class ScaleInvariantSignalNoiseRatio(_MeanOverSamplesMetric):
    """SI-SNR (JAX ``metrics.py:80``)."""

    is_differentiable = True
    higher_is_better = True

    def _batch_values(self, preds: Tensor, target: Tensor) -> Tensor:
        return scale_invariant_signal_noise_ratio(preds=preds, target=target)


class ComplexScaleInvariantSignalNoiseRatio(_MeanOverSamplesMetric):
    """C-SI-SNR (JAX ``metrics.py:102``) over complex or real-view ``(..., freq, time, 2)`` spectrograms."""

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Argument `zero_mean` must be a bool, but got {zero_mean}")
        self.zero_mean = zero_mean

    def _batch_values(self, preds: Tensor, target: Tensor) -> Tensor:
        return complex_scale_invariant_signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)


class SignalDistortionRatio(_MeanOverSamplesMetric):
    """SDR (JAX ``metrics.py:130``)."""

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag

    def _batch_values(self, preds: Tensor, target: Tensor) -> Tensor:
        return signal_distortion_ratio(preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag)


class ScaleInvariantSignalDistortionRatio(_MeanOverSamplesMetric):
    """SI-SDR (JAX ``metrics.py:168``)."""

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def _batch_values(self, preds: Tensor, target: Tensor) -> Tensor:
        return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=self.zero_mean)


class SourceAggregatedSignalDistortionRatio(_MeanOverSamplesMetric):
    """SA-SDR (JAX ``metrics.py:194``) over ``(batch, spk, time)``."""

    is_differentiable = True
    higher_is_better = True

    def __init__(self, scale_invariant: bool = True, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(scale_invariant, bool):
            raise ValueError(f"Expected argument `scale_invariant` to be a bool, but got {scale_invariant}")
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Argument `zero_mean` must be a bool, but got {zero_mean}")
        self.scale_invariant = scale_invariant
        self.zero_mean = zero_mean

    def _batch_values(self, preds: Tensor, target: Tensor) -> Tensor:
        return source_aggregated_signal_distortion_ratio(
            preds=preds, target=target, scale_invariant=self.scale_invariant, zero_mean=self.zero_mean
        )


class PermutationInvariantTraining(_MeanOverSamplesMetric):
    """PIT (JAX ``metrics.py:227``): the mean of each sample's best permutation's metric.

    The base keywords (and the port's ``device``) go to the metric; every other keyword goes to
    ``metric_func``, as in JAX.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import PermutationInvariantTraining
        >>> from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_noise_ratio
        >>> preds = torch.tensor([[[0.6, 0.4, 0.2], [0.2, 0.4, 0.6]]])
        >>> target = torch.tensor([[[0.2, 0.4, 0.6], [0.6, 0.4, 0.2]]])
        >>> metric = PermutationInvariantTraining(scale_invariant_signal_noise_ratio, device="cpu")
        >>> metric.update(preds, target)
        >>> print(f"{float(metric.compute()):.2f}")
        58.27
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, metric_func: Callable, mode: str = "speaker-wise", eval_func: str = "max", **kwargs: Any) -> None:
        base_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in _PIT_BASE_KEYWORDS}
        super().__init__(**base_kwargs)
        if eval_func not in ("max", "min"):
            raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
        if mode not in ("speaker-wise", "permutation-wise"):
            raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
        self.metric_func = metric_func
        self.mode = mode
        self.eval_func = eval_func
        self.kwargs = kwargs  # forwarded to metric_func

    def _batch_values(self, preds: Tensor, target: Tensor) -> Tensor:
        best_metric, _ = permutation_invariant_training(preds, target, self.metric_func, self.mode, self.eval_func,
                                                        **self.kwargs)
        return best_metric


class PerceptualEvaluationSpeechQuality(_MeanOverSamplesMetric):
    """PESQ (JAX ``metrics.py:278``) through the host ``pesq`` package, which it needs at construction."""

    is_differentiable = False
    higher_is_better = True
    jit_update = False
    scan_update = False

    def __init__(self, fs: int, mode: str, n_processes: int = 1, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _require_pesq()  # fail at construction when the package is missing, as the reference does
        self.fs = fs
        self.mode = mode
        self.n_processes = n_processes

    def _batch_values(self, preds: Tensor, target: Tensor) -> Tensor:
        return perceptual_evaluation_speech_quality(preds, target, self.fs, self.mode, n_processes=self.n_processes)


class ShortTimeObjectiveIntelligibility(_MeanOverSamplesMetric):
    """STOI (JAX ``metrics.py:308``) through the host ``pystoi`` package, which it needs at construction."""

    is_differentiable = False
    higher_is_better = True
    jit_update = False
    scan_update = False

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _require_pystoi()
        self.fs = fs
        self.extended = extended

    def _batch_values(self, preds: Tensor, target: Tensor) -> Tensor:
        return short_time_objective_intelligibility(preds, target, self.fs, self.extended)


class SpeechReverberationModulationEnergyRatio(_MeanOverSamplesMetric):
    """SRMR (JAX ``metrics.py:336``): non-intrusive, ``update(preds)``; the host float64 pipeline of
    ``functional/audio/srmr.py``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import SpeechReverberationModulationEnergyRatio
        >>> speech = torch.randn(8000, generator=torch.Generator().manual_seed(0))
        >>> metric = SpeechReverberationModulationEnergyRatio(fs=8000, device="cpu")
        >>> metric.update(speech)
        >>> float(metric.compute()) > 0
        True
    """

    is_differentiable = False
    higher_is_better = True
    jit_update = False
    scan_update = False

    def __init__(
        self,
        fs: int,
        n_cochlear_filters: int = 23,
        low_freq: float = 125,
        min_cf: float = 4,
        max_cf: Optional[float] = None,
        norm: bool = False,
        fast: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _srmr_arg_validate(fs, n_cochlear_filters, low_freq, min_cf, max_cf, norm, fast)
        self.fs = fs
        self.n_cochlear_filters = n_cochlear_filters
        self.low_freq = low_freq
        self.min_cf = min_cf
        self.max_cf = max_cf
        self.norm = norm
        self.fast = fast

    def _update(self, state: Dict[str, Tensor], preds: Tensor) -> Dict[str, Tensor]:
        vals = speech_reverberation_modulation_energy_ratio(
            preds, self.fs, self.n_cochlear_filters, self.low_freq, self.min_cf, self.max_cf, self.norm, self.fast
        )
        return {"sum_metric": state["sum_metric"] + torch.sum(vals), "total": state["total"] + vals.numel()}
