"""Image-quality module metrics (counterpart of ``torchmetrics_tpu/image/metrics.py``).

Each class keeps the JAX package's states, names, reductions and kind: scalar sums where the metric
streams (SSIM and MS-SSIM with ``elementwise_mean``/``sum``, PSNR without ``dim``, PSNR-B, UQI and
SAM with a reduction, RMSE-SW, TV with ``sum``/``mean``, VIF), ``cat`` lists where it needs the
whole data (ERGAS, RASE, D-lambda, the ``none`` reductions, PSNR's ``dim`` and SSIM's returned
images). Scalar-state classes run on the graph tier: their update makes no host read and builds
no tensor from host data (windows, pad indices and counts are made on the device). List-state
classes step eagerly, as path M's do. The input checks read shapes only, so they run inside
``_update``, where the JAX package runs them; no class defines ``_validate``, so ``update_batches``
copies nothing to the host.

Quirks kept from the JAX package: PSNR's zero-initialised ``min_target``/``max_target``
(``metrics.py:244-245``), PSNR-B's ``data_range`` state reduced with ``max``, SSIM's padding from
the gaussian's support even for the uniform kernel, MS-SSIM's ``data_range=None`` recomputed at each
scale, D-lambda's single band giving 0. TV's image count is int64, the port's count dtype, where
JAX holds int32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.d_lambda import (
    _spectral_distortion_index_check_inputs,
    _spectral_distortion_index_compute,
)
from torchmetrics_tpu_torch.functional.image.ergas import _ergas_check_inputs, _ergas_compute
from torchmetrics_tpu_torch.functional.image.psnr import _psnr_compute, _psnr_update
from torchmetrics_tpu_torch.functional.image.psnrb import _psnrb_compute, _psnrb_update
from torchmetrics_tpu_torch.functional.image.rase import relative_average_spectral_error
from torchmetrics_tpu_torch.functional.image.rmse_sw import _rmse_sw_update
from torchmetrics_tpu_torch.functional.image.sam import _sam_check_inputs, _sam_compute
from torchmetrics_tpu_torch.functional.image.ssim import _multiscale_ssim_update, _ssim_check_inputs, _ssim_update
from torchmetrics_tpu_torch.functional.image.tv import _total_variation_compute, _total_variation_update
from torchmetrics_tpu_torch.functional.image.uqi import _uqi_check_inputs, _uqi_compute
from torchmetrics_tpu_torch.functional.image.vif import _channels_to_batch, _vif_per_image_channel
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

_SUMMED = ("elementwise_mean", "sum")


def _zero() -> Tensor:
    return torch.zeros((), dtype=torch.float32)


class StructuralSimilarityIndexMeasure(Metric):
    """SSIM (``metrics.py:37``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import StructuralSimilarityIndexMeasure
        >>> x = torch.rand(1, 1, 16, 16, generator=torch.Generator().manual_seed(0))
        >>> metric = StructuralSimilarityIndexMeasure(data_range=1.0, device="cpu")
        >>> metric.update(x, x)
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    higher_is_better = True
    is_differentiable = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        gaussian_kernel: bool = True,
        sigma: Union[float, Sequence[float]] = 1.5,
        kernel_size: Union[int, Sequence[int]] = 11,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        return_full_image: bool = False,
        return_contrast_sensitivity: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        valid_reduction = ("elementwise_mean", "sum", "none", None)
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        if reduction in _SUMMED:
            self.add_state("similarity", _zero(), dist_reduce_fx="sum")
        else:
            self.add_state("similarity", [], dist_reduce_fx="cat")
        self.add_state("total", _zero(), dist_reduce_fx="sum")
        if return_contrast_sensitivity or return_full_image:
            self.add_state("image_return", [], dist_reduce_fx="cat")
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.return_full_image = return_full_image
        self.return_contrast_sensitivity = return_contrast_sensitivity

    def _update(self, state: Dict[str, Tensor], preds: Tensor, target: Tensor) -> Dict[str, Any]:
        preds, target = _ssim_check_inputs(preds, target)
        pack = _ssim_update(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size,
            self.data_range, self.k1, self.k2, self.return_full_image, self.return_contrast_sensitivity,
        )
        similarity, image = pack if isinstance(pack, tuple) else (pack, None)
        out: Dict[str, Any] = {"total": state["total"] + preds.shape[0]}
        if image is not None:
            out["image_return"] = image
        out["similarity"] = state["similarity"] + torch.sum(similarity) if self.reduction in _SUMMED else similarity
        return out

    def _compute(self, state: Dict[str, Any]) -> Any:
        similarity = state["similarity"] / state["total"] if self.reduction == "elementwise_mean" else state["similarity"]
        if self.return_contrast_sensitivity or self.return_full_image:
            return similarity, state["image_return"]
        return similarity


class MultiScaleStructuralSimilarityIndexMeasure(Metric):
    """MS-SSIM (``metrics.py:122``)."""

    higher_is_better = True
    is_differentiable = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        gaussian_kernel: bool = True,
        kernel_size: Union[int, Sequence[int]] = 11,
        sigma: Union[float, Sequence[float]] = 1.5,
        reduction: Optional[str] = "elementwise_mean",
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
        normalize: Optional[str] = "relu",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        valid_reduction = ("elementwise_mean", "sum", "none", None)
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        if reduction in _SUMMED:
            self.add_state("similarity", _zero(), dist_reduce_fx="sum")
        else:
            self.add_state("similarity", [], dist_reduce_fx="cat")
        self.add_state("total", _zero(), dist_reduce_fx="sum")
        if not (isinstance(kernel_size, (Sequence, int))):
            raise ValueError("Argument `kernel_size` expected to be an sequence or an int")
        if not isinstance(betas, tuple) or not all(isinstance(beta, float) for beta in betas):
            raise ValueError("Argument `betas` is expected to be a tuple of floats.")
        if normalize and normalize not in ("relu", "simple"):
            raise ValueError("Argument `normalize` to be expected either `None` or one of 'relu' or 'simple'")
        self.gaussian_kernel = gaussian_kernel
        self.sigma = sigma
        self.kernel_size = kernel_size
        self.reduction = reduction
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.betas = betas
        self.normalize = normalize

    def _update(self, state: Dict[str, Tensor], preds: Tensor, target: Tensor) -> Dict[str, Any]:
        preds, target = _ssim_check_inputs(preds, target)
        similarity = _multiscale_ssim_update(
            preds, target, self.gaussian_kernel, self.sigma, self.kernel_size,
            self.data_range, self.k1, self.k2, self.betas, self.normalize,
        )
        total = state["total"] + preds.shape[0]
        if self.reduction in _SUMMED:
            return {"similarity": state["similarity"] + torch.sum(similarity), "total": total}
        return {"similarity": similarity, "total": total}

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        if self.reduction == "elementwise_mean":
            return state["similarity"] / state["total"]
        return state["similarity"]


class PeakSignalNoiseRatio(Metric):
    """PSNR (``metrics.py:200``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import PeakSignalNoiseRatio
        >>> metric = PeakSignalNoiseRatio(data_range=3.0, device="cpu")
        >>> metric.update(torch.tensor([[0.0, 1.0], [2.0, 3.0]]), torch.tensor([[3.0, 2.0], [1.0, 0.0]]))
        >>> print(f"{float(metric.compute()):.2f}")
        2.55
    """

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        data_range: Optional[Union[float, Tuple[float, float]]] = None,
        base: float = 10.0,
        reduction: Optional[str] = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
        if dim is None:
            self.add_state("sum_squared_error", _zero(), dist_reduce_fx="sum")
            self.add_state("total", _zero(), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", [], dist_reduce_fx="cat")
            self.add_state("total", [], dist_reduce_fx="cat")
        self.clamping_range: Optional[Tuple[float, float]] = None
        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range_val = None
            # the observed target range, zero-initialised as in JAX and the reference (psnr.py:110-115 there)
            self.add_state("min_target", _zero(), dist_reduce_fx="min")
            self.add_state("max_target", _zero(), dist_reduce_fx="max")
        elif isinstance(data_range, tuple):
            self.clamping_range = (float(data_range[0]), float(data_range[1]))
            self.data_range_val = float(data_range[1] - data_range[0])
        else:
            self.data_range_val = float(data_range)
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, Sequence) else dim

    def _update(self, state: Dict[str, Tensor], preds: Tensor, target: Tensor) -> Dict[str, Any]:
        preds, target = preds.to(torch.float32), target.to(torch.float32)
        if self.clamping_range is not None:
            preds = torch.clamp(preds, *self.clamping_range)
            target = torch.clamp(target, *self.clamping_range)
        sum_squared_error, num_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is not None:
            return {"sum_squared_error": sum_squared_error.reshape(-1), "total": num_obs.reshape(-1)}
        out = {"sum_squared_error": state["sum_squared_error"] + sum_squared_error, "total": state["total"] + num_obs}
        if self.data_range_val is None:
            out["min_target"] = torch.minimum(torch.min(target), state["min_target"])
            out["max_target"] = torch.maximum(torch.max(target), state["max_target"])
        return out

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        sse = state["sum_squared_error"]
        if self.data_range_val is not None:
            data_range = torch.full((), self.data_range_val, dtype=torch.float32, device=sse.device)
        else:
            data_range = state["max_target"] - state["min_target"]
        return _psnr_compute(sse, state["total"], data_range, base=self.base, reduction=self.reduction)


class PeakSignalNoiseRatioWithBlockedEffect(Metric):
    """PSNR-B (``metrics.py:283``)."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, block_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(block_size, int) or block_size < 1:
            raise ValueError("Argument `block_size` should be a positive integer")
        self.block_size = block_size
        self.add_state("sum_squared_error", _zero(), dist_reduce_fx="sum")
        self.add_state("total", _zero(), dist_reduce_fx="sum")
        self.add_state("bef", _zero(), dist_reduce_fx="sum")
        self.add_state("data_range", _zero(), dist_reduce_fx="max")

    def _update(self, state: Dict[str, Tensor], preds: Tensor, target: Tensor) -> Dict[str, Tensor]:
        sum_squared_error, bef, num_obs = _psnrb_update(preds, target, block_size=self.block_size)
        target = target.to(torch.float32)
        return {
            "sum_squared_error": state["sum_squared_error"] + sum_squared_error,
            "bef": state["bef"] + bef,
            "total": state["total"] + num_obs,
            "data_range": torch.maximum(state["data_range"], torch.max(target) - torch.min(target)),
        }

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        return _psnrb_compute(state["sum_squared_error"], state["bef"], state["total"], state["data_range"])


class UniversalImageQualityIndex(Metric):
    """UQI (``metrics.py:328``)."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: Optional[str] = "elementwise_mean",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if reduction is None or reduction == "none":
            self.add_state("preds", [], dist_reduce_fx="cat")
            self.add_state("target", [], dist_reduce_fx="cat")
        else:
            self.add_state("sum_uqi", _zero(), dist_reduce_fx="sum")
            self.add_state("numel", _zero(), dist_reduce_fx="sum")
        self.kernel_size = tuple(kernel_size)
        self.sigma = tuple(sigma)
        self.reduction = reduction

    def _update(self, state: Dict[str, Tensor], preds: Tensor, target: Tensor) -> Dict[str, Tensor]:
        preds, target = _uqi_check_inputs(preds, target)
        if self.reduction is None or self.reduction == "none":
            return {"preds": preds, "target": target}
        uqi_score = _uqi_compute(preds, target, self.kernel_size, self.sigma, reduction="sum")
        ps = preds.shape
        n = ps[0] * ps[1] * (ps[2] - self.kernel_size[0] + 1) * (ps[3] - self.kernel_size[1] + 1)
        return {"sum_uqi": state["sum_uqi"] + uqi_score, "numel": state["numel"] + n}

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        if self.reduction is None or self.reduction == "none":
            return _uqi_compute(state["preds"], state["target"], self.kernel_size, self.sigma, self.reduction)
        return state["sum_uqi"] / state["numel"] if self.reduction == "elementwise_mean" else state["sum_uqi"]


class SpectralAngleMapper(Metric):
    """SAM (``metrics.py:382``)."""

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction is None or reduction == "none":
            self.add_state("preds", [], dist_reduce_fx="cat")
            self.add_state("target", [], dist_reduce_fx="cat")
        else:
            self.add_state("sum_sam", _zero(), dist_reduce_fx="sum")
            self.add_state("numel", _zero(), dist_reduce_fx="sum")
        self.reduction = reduction

    def _update(self, state: Dict[str, Tensor], preds: Tensor, target: Tensor) -> Dict[str, Tensor]:
        preds, target = _sam_check_inputs(preds, target)
        if self.reduction is None or self.reduction == "none":
            return {"preds": preds, "target": target}
        sam_score = _sam_compute(preds, target, reduction="sum")
        ps = preds.shape
        return {"sum_sam": state["sum_sam"] + sam_score, "numel": state["numel"] + ps[0] * ps[2] * ps[3]}

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        if self.reduction is None or self.reduction == "none":
            return _sam_compute(state["preds"], state["target"], self.reduction)
        return state["sum_sam"] / state["numel"] if self.reduction == "elementwise_mean" else state["sum_sam"]


class ErrorRelativeGlobalDimensionlessSynthesis(Metric):
    """ERGAS (``metrics.py:426``)."""

    higher_is_better = False
    is_differentiable = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, ratio: float = 4, reduction: Optional[str] = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")
        self.ratio = ratio
        self.reduction = reduction

    def _update(self, state: Dict[str, Tensor], preds: Tensor, target: Tensor) -> Dict[str, Tensor]:
        preds, target = _ergas_check_inputs(preds, target)
        return {"preds": preds, "target": target}

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        return _ergas_compute(state["preds"], state["target"], self.ratio, self.reduction)


class RelativeAverageSpectralError(Metric):
    """RASE (``metrics.py:461``)."""

    higher_is_better = False
    is_differentiable = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError(f"Argument `window_size` must be a positive integer, but got {window_size}")
        self.window_size = window_size
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def _update(self, state: Dict[str, Tensor], preds: Tensor, target: Tensor) -> Dict[str, Tensor]:
        return {"preds": preds.to(torch.float32), "target": target.to(torch.float32)}

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        return relative_average_spectral_error(state["preds"], state["target"], self.window_size)


class RootMeanSquaredErrorUsingSlidingWindow(Metric):
    """Sliding-window RMSE (``metrics.py:496``): the scalar accumulators only, as in JAX."""

    higher_is_better = False
    is_differentiable = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, window_size: int = 8, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(window_size, int) or window_size < 1:
            raise ValueError("Argument `window_size` must be a positive integer.")
        self.window_size = window_size
        self.add_state("rmse_val_sum", _zero(), dist_reduce_fx="sum")
        self.add_state("total_images", _zero(), dist_reduce_fx="sum")

    def _update(self, state: Dict[str, Tensor], preds: Tensor, target: Tensor) -> Dict[str, Tensor]:
        rmse_val_sum, _, total_images = _rmse_sw_update(
            preds, target, self.window_size,
            rmse_val_sum=state["rmse_val_sum"], rmse_map=None, total_images=state["total_images"],
        )
        return {"rmse_val_sum": rmse_val_sum, "total_images": total_images}

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        return state["rmse_val_sum"] / state["total_images"]


class SpectralDistortionIndex(Metric):
    """D-lambda (``metrics.py:538``)."""

    higher_is_better = True
    is_differentiable = True
    full_state_update = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, p: int = 1, reduction: str = "elementwise_mean", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(p, int) or p <= 0:
            raise ValueError(f"`p` must be a positive integer. Got p: {p}.")
        valid_reduction = ("elementwise_mean", "sum", "none")
        if reduction not in valid_reduction:
            raise ValueError(f"Expected argument `reduction` be one of {valid_reduction} but got {reduction}")
        self.p = p
        self.reduction = reduction
        self.add_state("preds", [], dist_reduce_fx="cat")
        self.add_state("target", [], dist_reduce_fx="cat")

    def _update(self, state: Dict[str, Tensor], preds: Tensor, target: Tensor) -> Dict[str, Tensor]:
        preds, target = _spectral_distortion_index_check_inputs(preds, target)
        return {"preds": preds, "target": target}

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        return _spectral_distortion_index_compute(state["preds"], state["target"], self.p, self.reduction)


class TotalVariation(Metric):
    """Total variation (``metrics.py:579``); ``score`` is a list state only with ``reduction="none"``."""

    full_state_update = False
    is_differentiable = True
    higher_is_better = False
    plot_lower_bound = 0.0

    def __init__(self, reduction: Optional[str] = "sum", **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if reduction is not None and reduction not in ("sum", "mean", "none"):
            raise ValueError("Argument `reduction` must be either 'sum', 'mean', 'none' or None")
        self.reduction = reduction
        if reduction is None or reduction == "none":
            self.add_state("score_list", [], dist_reduce_fx="cat")
        else:
            self.add_state("score", _zero(), dist_reduce_fx="sum")
        self.add_state("num_elements", torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def _update(self, state: Dict[str, Tensor], img: Tensor) -> Dict[str, Tensor]:
        score, num_elements = _total_variation_update(img)
        out = {"num_elements": state["num_elements"] + num_elements}
        if self.reduction is None or self.reduction == "none":
            out["score_list"] = score
        else:
            out["score"] = state["score"] + torch.sum(score)
        return out

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        if self.reduction is None or self.reduction == "none":
            score = state["score_list"]
            if isinstance(score, list):
                score = torch.cat(score) if score else torch.zeros((0,), device=self.device)
        else:
            score = state["score"]
        return _total_variation_compute(score, state["num_elements"], self.reduction)


class VisualInformationFidelity(Metric):
    """VIF-p (``metrics.py:629``): per image, the mean over its channels, summed over the batch."""

    is_differentiable = True
    higher_is_better = True
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, sigma_n_sq: float = 2.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(sigma_n_sq, (float, int)) or sigma_n_sq < 0:
            raise ValueError(f"Argument `sigma_n_sq` must be a positive float or int, but got {sigma_n_sq}")
        self.add_state("vif_score", _zero(), dist_reduce_fx="sum")
        self.add_state("total", _zero(), dist_reduce_fx="sum")
        self.sigma_n_sq = sigma_n_sq

    def _update(self, state: Dict[str, Tensor], preds: Tensor, target: Tensor) -> Dict[str, Tensor]:
        preds, target = preds.to(torch.float32), target.to(torch.float32)
        n, c = preds.shape[:2]
        per = _vif_per_image_channel(_channels_to_batch(preds), _channels_to_batch(target), self.sigma_n_sq).reshape(c, n)
        vif_per_image = torch.mean(per, dim=0) if c > 1 else per.reshape(-1)
        return {"vif_score": state["vif_score"] + torch.sum(vif_per_image), "total": state["total"] + n}

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        return state["vif_score"] / state["total"]
