"""Generative-model image metrics: FID, KID, IS, MiFID, LPIPS, PPL (counterpart of
``torchmetrics_tpu/image/generative.py``).

The classes keep the JAX package's states, names, flags and checks:

- **Feature extractors are the caller's.** ``feature`` is a callable ``imgs -> (N, d)`` or ``None``
  (the inputs are features already); the reference's integer layer ids and ``"logits_unbiased"``
  resolve through ``utils/pretrained.py`` to torch-fidelity's InceptionV3, or raise its
  ``ModuleNotFoundError`` text. The metric hands a callable (``feature``, ``net_type``,
  ``generator``, ``sim_net``) its inputs on the metric's own device and never moves a caller's
  module. The updates run eagerly (``jit_update = False``, as in JAX: the extractor is user code).
- **FID's states are JAX's float32 streaming moments,** Neumaier-compensated (``_kahan_add``): per
  distribution the feature sum, the sum of each batch's centred Gram matrix and the sum of
  ``n·μ_b μ_bᵀ``, each with its compensation, and the count; 14 states, all ``sum``-reduced, so a JAX
  state loads through ``interop.load_numpy_state`` and syncs as a sum. ``_kahan_add`` runs as eager
  elementwise operations, each rounded to float32, which is what its compensation relies on; a fused
  or compiled form could contract it.
- **FID's and MiFID's compute is float64** (queue C of the roadmap): μ, Σ and both symmetric
  eigendecompositions of ``tr((Σ₁Σ₂)^½)`` are formed in float64 on the metric's device. At d = 2048
  the distance is a small difference of traces about a hundred times larger, and float32 ``eigh``
  resolves small eigenvalues only to about 1e-7·λ_max; the reference computes in float64 too. The
  value is returned in float32, as JAX returns it.
- **The random subsets are JAX's:** KID and IS draw from ``np.random.RandomState(seed)`` on the host
  in JAX's order. KID copies all its index rows to the device at once and scores the subsets in
  batched products, in chunks of at most ``BLOCK_BYTES``; MiFID's nearest-neighbour cosine search
  takes its row minima in blocks of rows of at most ``BLOCK_BYTES`` (JAX forms the whole product).
- Every matrix product runs in IEEE float32 whatever TF32 flags the caller set
  (``utils/precision.full_float32``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.precision import full_float32

FeatureExtractor = Optional[Callable[[Tensor], Tensor]]

_INCEPTION_LAYERS = (64, 192, 768, 2048)

_METRIC_DISPLAY = {
    "FrechetInceptionDistance": "FrechetInceptionDistance",
    "KernelInceptionDistance": "Kernel Inception Distance",
    "InceptionScore": "InceptionScore",
    "MemorizationInformedFrechetInceptionDistance": "MemorizationInformedFrechetInceptionDistance",
}

#: the largest block of KID's batched kernels and of MiFID's cosine rows, in bytes
BLOCK_BYTES = 1 << 30


def _resolve_extractor(
    feature: Union[int, str, FeatureExtractor],
    metric_name: str,
    valid_strs: Tuple[str, ...] = (),
    device: Optional[torch.device] = None,
) -> Tuple[FeatureExtractor, Optional[int]]:
    """Map the ``feature`` argument to (extractor, num_features if known) (JAX ``generative.py:48``).

    Integers (and the strings in ``valid_strs``) resolve through ``utils/pretrained.py`` to
    torch-fidelity's InceptionV3 on ``device`` where it is installed, and raise the reference's
    ``ModuleNotFoundError`` otherwise.
    """
    if feature is None:
        return None, None
    if isinstance(feature, (int, str)) and not callable(feature):
        if isinstance(feature, int) and feature not in _INCEPTION_LAYERS:
            raise ValueError(
                f"Integer input to argument `feature` must be one of {_INCEPTION_LAYERS}, but got {feature}."
            )
        if isinstance(feature, str) and feature not in valid_strs:
            raise ValueError(
                f"String input to argument `feature` must be one of {list(valid_strs) or '(no strings accepted)'},"
                f" but got {feature!r}."
            )
        from torchmetrics_tpu_torch.utils.pretrained import inception_feature_extractor

        display = _METRIC_DISPLAY.get(metric_name, metric_name)
        num_features = feature if isinstance(feature, int) else None
        return inception_feature_extractor(feature, display, device=device), num_features
    if callable(feature):
        return feature, None
    raise TypeError("Got unknown input to argument `feature`")


def _symmetric(a: Tensor) -> Tensor:
    """``(A + Aᵀ) / 2``, which ``jnp.linalg.eigh`` takes by default (``symmetrize_input=True``)."""
    return (a + a.transpose(-1, -2)) / 2


def _sqrtm_trace_product(sigma1: Tensor, sigma2: Tensor) -> Tensor:
    """``tr((Σ₁ Σ₂)^{1/2})`` for symmetric PSD inputs by two ``eigh`` factorisations, in their dtype."""
    with full_float32():
        evals1, evecs1 = torch.linalg.eigh(_symmetric(sigma1))
        sqrt1 = (evecs1 * torch.sqrt(torch.clamp(evals1, min=0.0))) @ evecs1.T
        inner = sqrt1 @ sigma2 @ sqrt1
        evals = torch.linalg.eigvalsh(_symmetric(inner))
    return torch.sum(torch.sqrt(torch.clamp(evals, min=0.0)))


def _compute_fid(mu1: Tensor, sigma1: Tensor, mu2: Tensor, sigma2: Tensor) -> Tensor:
    """Fréchet distance between two gaussians (JAX ``generative.py:92``), in the inputs' dtype."""
    a = torch.sum(torch.square(mu1 - mu2))
    b = torch.trace(sigma1) + torch.trace(sigma2)
    c = _sqrtm_trace_product(sigma1, sigma2)
    return a + b - 2 * c


class _FeatureStatsMetric(Metric):
    """Extractor resolution and the real/fake dispatch (JAX ``generative.py:100``)."""

    jit_update = False  # the extractor is arbitrary user code, and `real` a static branch
    # forward() routes through the overridden update(), so that the extractor runs
    full_state_update = True

    def __init__(
        self,
        feature: Union[int, str, FeatureExtractor],
        reset_real_features: bool = True,
        normalize: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.extractor, self._num_features_hint = _resolve_extractor(feature, type(self).__name__, device=self.device)
        if not isinstance(reset_real_features, bool):
            raise ValueError("Argument `reset_real_features` expected to be a bool")
        self.reset_real_features = reset_real_features
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize

    def _coerce(self, args: tuple, kwargs: dict) -> tuple:
        """The images or features as a tensor on the metric's device; the ``real`` flag stays a Python
        bool, the static branch it is in JAX, so that no update reads it back from the device."""
        (first,), _ = super()._coerce(args[:1], {})
        return (first, *args[1:]), kwargs

    def _extract(self, imgs: Any) -> Tensor:
        imgs = torch.as_tensor(imgs, device=self.device)
        if self.extractor is not None:
            if self.normalize:  # [0, 1] floats -> uint8 [0, 255], truncating as JAX's astype does
                imgs = (imgs * 255).to(torch.uint8)
            imgs = self.extractor(imgs)
        feats = torch.as_tensor(imgs, dtype=torch.float32, device=self.device)
        return feats[None] if feats.ndim == 1 else feats

    def update(self, imgs: Any, real: bool = True) -> None:  # noqa: D102
        super().update(self._extract(imgs), bool(real))

    def update_batches(self, imgs: Any, real: bool = True) -> None:
        """A loop of ``update`` over the leading axis: the extractor is user code and ``real`` a static
        flag, so there is no one-step sweep (JAX ``generative.py:139``)."""
        for i in range(len(imgs)):
            self.update(imgs[i], real=real)

    def reset(self) -> None:
        """Keep the real distribution's states across resets when configured (JAX ``generative.py:144``)."""
        if self.reset_real_features:
            super().reset()
            return
        keep_t = {k: v for k, v in self._state.tensors.items() if k.startswith("real_")}
        keep_l = {k: list(v) for k, v in self._state.lists.items() if k.startswith("real_")}
        super().reset()
        self._state.tensors.update(keep_t)
        self._state.lists.update(keep_l)


def _kahan_add(total: Tensor, comp: Tensor, contribution: Tensor) -> Tuple[Tensor, Tensor]:
    """Neumaier compensated add: ``(total, comp) += contribution`` (JAX ``generative.py:156``).

    ``comp`` carries the low-order bits each float32 add drops; the corrected value is ``total + comp``.
    Both are plain sums, so ``dist_reduce_fx="sum"`` stays valid. Eager operations only: each must
    round to float32 on its own.
    """
    t = total + contribution
    comp = comp + torch.where(
        torch.abs(total) >= torch.abs(contribution),
        (total - t) + contribution,
        (contribution - t) + total,
    )
    return t, comp


class FrechetInceptionDistance(_FeatureStatsMetric):
    """FID (JAX ``generative.py:171``): float32 compensated moment states, a float64 compute.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import FrechetInceptionDistance
        >>> g = torch.Generator().manual_seed(0)
        >>> metric = FrechetInceptionDistance(feature=None, num_features=4, device="cpu")
        >>> metric.update(torch.randn(64, 4, generator=g), real=True)
        >>> metric.update(torch.randn(64, 4, generator=g) + 1, real=False)
        >>> print(f"{float(metric.compute()):.4f}")
        4.8570
    """

    higher_is_better = False
    is_differentiable = False
    full_state_update = True
    plot_lower_bound = 0.0
    jit_compute = False  # the sample-count guard reads the counts on the host

    def __init__(
        self,
        feature: Union[int, str, FeatureExtractor] = 2048,
        reset_real_features: bool = True,
        normalize: bool = False,
        num_features: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(feature, reset_real_features, normalize, **kwargs)
        if num_features is None:
            if self._num_features_hint is not None:
                num_features = self._num_features_hint
            elif self.extractor is None:
                raise ValueError("`num_features` must be given when `feature` is None (raw-feature mode).")
            else:  # the extractor's width, probed on one blank image on the metric's device
                probe = self.extractor(torch.zeros((1, 3, 299, 299), dtype=torch.float32, device=self.device))
                num_features = int(torch.as_tensor(probe).shape[-1])
        d = num_features
        for prefix in ("real", "fake"):
            for name, shape in (("features_sum", (d,)), ("features_cov_sum", (d, d)), ("mu_outer_sum", (d, d))):
                self.add_state(f"{prefix}_{name}", torch.zeros(shape, dtype=torch.float32), dist_reduce_fx="sum")
                self.add_state(f"{prefix}_{name}_comp", torch.zeros(shape, dtype=torch.float32), dist_reduce_fx="sum")
            self.add_state(f"{prefix}_features_num_samples", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _update(self, state: Dict[str, Tensor], features: Tensor, real: bool) -> Dict[str, Tensor]:
        prefix = "real" if real else "fake"
        n = features.shape[0]
        bmean = torch.mean(features, dim=0)
        centered = features - bmean
        with full_float32():
            gram = centered.T @ centered
        out = {}
        for name, contribution in (
            ("features_sum", torch.sum(features, dim=0)),
            ("features_cov_sum", gram),
            ("mu_outer_sum", n * torch.outer(bmean, bmean)),
        ):
            total, comp = _kahan_add(state[f"{prefix}_{name}"], state[f"{prefix}_{name}_comp"], contribution)
            out[f"{prefix}_{name}"] = total
            out[f"{prefix}_{name}_comp"] = comp
        out[f"{prefix}_features_num_samples"] = state[f"{prefix}_features_num_samples"] + n
        return out

    @staticmethod
    def _stats(state: Dict[str, Tensor], prefix: str, dtype: torch.dtype = torch.float64) -> Tuple[Tensor, Tensor]:
        """μ and Σ of one distribution from the compensated sums, formed in ``dtype`` (float64; the JAX
        package's float32 formula with ``torch.float32``)."""
        n = state[f"{prefix}_features_num_samples"].to(dtype)

        def corrected(name: str) -> Tensor:
            return state[f"{prefix}_{name}"].to(dtype) + state[f"{prefix}_{name}_comp"].to(dtype)

        mu = corrected("features_sum") / n
        cov_num = corrected("features_cov_sum") + corrected("mu_outer_sum") - n * torch.outer(mu, mu)
        return mu, cov_num / (n - 1)

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        if float(state["real_features_num_samples"]) < 2 or float(state["fake_features_num_samples"]) < 2:
            raise RuntimeError(
                "More than one sample is required for both the real and fake distributed to compute FID"
            )
        mu_r, cov_r = self._stats(state, "real")
        mu_f, cov_f = self._stats(state, "fake")
        return _compute_fid(mu_r, cov_r, mu_f, cov_f).to(torch.float32)


def _poly_kernel(f1: Tensor, f2: Tensor, degree: int, gamma: Optional[float], coef: float) -> Tensor:
    """``(f1 f2ᵀ γ + coef)^degree`` over the last two axes, each step rounded as JAX's (in place)."""
    if gamma is None:
        gamma = 1.0 / f1.shape[-1]
    with full_float32():
        k = torch.matmul(f1, f2.transpose(-1, -2))
    return k.mul_(gamma).add_(coef).pow_(degree)


def _poly_mmd(f_real: Tensor, f_fake: Tensor, degree: int, gamma: Optional[float], coef: float) -> Tensor:
    """Unbiased polynomial-kernel MMD² (JAX ``generative.py:279``) of one subset ``(m, d)``, or of a
    stack of subsets ``(s, m, d)`` at once."""
    k_11 = _poly_kernel(f_real, f_real, degree, gamma, coef)
    k_22 = _poly_kernel(f_fake, f_fake, degree, gamma, coef)
    k_12 = _poly_kernel(f_real, f_fake, degree, gamma, coef)
    m = k_11.shape[-1]

    def off_diagonal_sum(k: Tensor) -> Tensor:
        return torch.sum(k, dim=(-2, -1)) - torch.diagonal(k, dim1=-2, dim2=-1).sum(-1)

    kt_xx_sum, kt_yy_sum = off_diagonal_sum(k_11), off_diagonal_sum(k_22)
    k_xy_sum = torch.sum(k_12, dim=(-2, -1))
    return (kt_xx_sum + kt_yy_sum) / (m * (m - 1)) - 2 * k_xy_sum / (m**2)


class KernelInceptionDistance(_FeatureStatsMetric):
    """KID (JAX ``generative.py:291``): resampled polynomial MMD over feature lists.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import KernelInceptionDistance
        >>> g = torch.Generator().manual_seed(0)
        >>> metric = KernelInceptionDistance(feature=None, subsets=3, subset_size=16, seed=0, device="cpu")
        >>> metric.update(torch.randn(32, 8, generator=g), real=True)
        >>> metric.update(torch.randn(32, 8, generator=g) + 1, real=False)
        >>> kid_mean, kid_std = metric.compute()
        >>> print(f"{float(kid_mean):.4f}")
        13.8228
    """

    higher_is_better = False
    is_differentiable = False
    full_state_update = True
    plot_lower_bound = 0.0
    jit_compute = False  # the subsets are drawn on the host

    def __init__(
        self,
        feature: Union[int, str, FeatureExtractor] = 2048,
        subsets: int = 100,
        subset_size: int = 1000,
        degree: int = 3,
        gamma: Optional[float] = None,
        coef: float = 1.0,
        reset_real_features: bool = True,
        normalize: bool = False,
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(feature, reset_real_features, normalize, **kwargs)
        if not (isinstance(subsets, int) and subsets > 0):
            raise ValueError("Argument `subsets` expected to be integer larger than 0")
        self.subsets = subsets
        if not (isinstance(subset_size, int) and subset_size > 0):
            raise ValueError("Argument `subset_size` expected to be integer larger than 0")
        self.subset_size = subset_size
        if not (isinstance(degree, int) and degree > 0):
            raise ValueError("Argument `degree` expected to be integer larger than 0")
        self.degree = degree
        if gamma is not None and not (isinstance(gamma, float) and gamma > 0):
            raise ValueError("Argument `gamma` expected to be `None` or float larger than 0")
        self.gamma = gamma
        if not (isinstance(coef, float) and coef > 0):
            raise ValueError("Argument `coef` expected to be float larger than 0")
        self.coef = coef
        self.seed = seed  # seeded resampling (the reference uses the ambient torch RNG)
        self.add_state("real_features", [], dist_reduce_fx=None)
        self.add_state("fake_features", [], dist_reduce_fx=None)

    def _update(self, state: Dict[str, Tensor], features: Tensor, real: bool) -> Dict[str, Tensor]:
        return {("real_features" if real else "fake_features"): features}

    def _compute(self, state: Dict[str, Any]) -> Tuple[Tensor, Tensor]:
        real_features, fake_features = state["real_features"], state["fake_features"]
        if isinstance(real_features, list) or isinstance(fake_features, list):
            raise RuntimeError("No real/fake features accumulated; call `update` before `compute`.")
        n_real, n_fake = real_features.shape[0], fake_features.shape[0]
        m = self.subset_size
        if n_real < m or n_fake < m:
            raise ValueError("Argument `subset_size` should be smaller than the number of samples")
        rng = np.random.RandomState(self.seed)  # JAX's draws: per subset the real rows' permutation, then the fake's
        rows = [(rng.permutation(n_real)[:m], rng.permutation(n_fake)[:m]) for _ in range(self.subsets)]
        rows = torch.from_numpy(np.stack(rows, axis=1)).to(real_features.device)  # one copy to the device
        d = real_features.shape[1]
        per_subset = 4 * (2 * m * d + 4 * m * m)  # the two gathers and the kernels alive at once
        chunk = max(1, BLOCK_BYTES // per_subset)
        scores = [
            _poly_mmd(real_features[rows[0, s:s + chunk]], fake_features[rows[1, s:s + chunk]], self.degree,
                      self.gamma, self.coef)
            for s in range(0, self.subsets, chunk)
        ]
        kid = torch.cat(scores)
        return torch.mean(kid), torch.std(kid, correction=0)


class InceptionScore(Metric):
    """IS (JAX ``generative.py:372``): exp KL between the conditional and marginal label distributions.

    ``feature`` is a callable giving logits ``(N, num_classes)``, or ``None`` for logits as inputs.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import InceptionScore
        >>> logits = 4 * torch.randn(64, 10, generator=torch.Generator().manual_seed(0))
        >>> metric = InceptionScore(feature=None, splits=2, seed=0, device="cpu")
        >>> metric.update(logits)
        >>> score_mean, score_std = metric.compute()
        >>> print(f"{float(score_mean):.4f}")
        4.7357
    """

    higher_is_better = True
    is_differentiable = False
    full_state_update = True  # forward() routes through the overridden update() (extractor)
    plot_lower_bound = 0.0
    jit_update = False
    jit_compute = False  # the permutation is drawn on the host, the chunks are a Python loop

    def __init__(
        self,
        feature: Union[int, str, FeatureExtractor] = "logits_unbiased",
        splits: int = 10,
        normalize: bool = False,
        seed: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.extractor, _ = _resolve_extractor(feature, type(self).__name__, valid_strs=("logits_unbiased",),
                                               device=self.device)
        if not isinstance(normalize, bool):
            raise ValueError("Argument `normalize` expected to be a bool")
        self.normalize = normalize
        self.splits = splits
        self.seed = seed
        self.add_state("features", [], dist_reduce_fx=None)

    def update(self, imgs: Any) -> None:  # noqa: D102
        imgs = torch.as_tensor(imgs, device=self.device)
        if self.extractor is not None:
            if self.normalize:
                imgs = (imgs * 255).to(torch.uint8)
            imgs = self.extractor(imgs)
        super().update(torch.as_tensor(imgs, dtype=torch.float32, device=self.device))

    def update_batches(self, imgs: Any) -> None:
        """A loop of ``update`` over the leading axis (user extractor, list state)."""
        for i in range(len(imgs)):
            self.update(imgs[i])

    def _update(self, state: Dict[str, Tensor], features: Tensor) -> Dict[str, Tensor]:
        return {"features": features}

    def _compute(self, state: Dict[str, Any]) -> Tuple[Tensor, Tensor]:
        features = state["features"]
        if isinstance(features, list):
            raise RuntimeError("No features accumulated; call `update` before `compute`.")
        n = features.shape[0]
        perm = np.random.RandomState(self.seed).permutation(n)
        features = features[torch.from_numpy(perm).to(features.device)]
        log_prob = torch.log_softmax(features, dim=1)
        prob = torch.exp(log_prob)
        chunk = -(-n // self.splits)  # torch.chunk's split sizes: ceil(N / splits) a chunk
        kl_scores = []
        for start in range(0, n, chunk):
            p = prob[start:start + chunk]
            log_p = log_prob[start:start + chunk]
            mean_p = torch.mean(p, dim=0, keepdim=True)
            kl = torch.sum(p * (log_p - torch.log(mean_p)), dim=1)
            kl_scores.append(torch.exp(torch.mean(kl)))
        kl = torch.stack(kl_scores)
        return torch.mean(kl), torch.std(kl, correction=1)


def _cosine_distance(features1: Tensor, features2: Tensor, eps: float = 0.1) -> Tensor:
    """Mean over the rows of ``features1`` of the least ``1 - |cos|`` to a row of ``features2``, with
    MiFID's threshold (JAX ``generative.py:456``). All-zero rows are dropped by one host read, as in
    JAX; the row minima are taken in blocks of rows of at most ``BLOCK_BYTES``, which changes no value."""
    f1 = features1[torch.sum(features1, dim=1) != 0]
    f2 = features2[torch.sum(features2, dim=1) != 0]
    f1 = f1 / torch.linalg.vector_norm(f1, dim=1, keepdim=True)
    f2 = f2 / torch.linalg.vector_norm(f2, dim=1, keepdim=True)
    rows = max(1, BLOCK_BYTES // (4 * max(1, f2.shape[0])))
    minima = []
    for start in range(0, f1.shape[0], rows):
        with full_float32():
            d = f1[start:start + rows] @ f2.T
        minima.append(d.abs_().neg_().add_(1.0).amin(dim=1))  # 1 - |cos|, in place
    mean_min_d = torch.mean(torch.cat(minima))
    return torch.where(mean_min_d < eps, mean_min_d, torch.ones_like(mean_min_d))


class MemorizationInformedFrechetInceptionDistance(_FeatureStatsMetric):
    """MiFID (JAX ``generative.py:467``): FID penalised by memorisation of the training set.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import MemorizationInformedFrechetInceptionDistance
        >>> g = torch.Generator().manual_seed(0)
        >>> metric = MemorizationInformedFrechetInceptionDistance(feature=None, device="cpu")
        >>> metric.update(torch.rand(64, 8, generator=g), real=True)
        >>> metric.update(torch.rand(64, 8, generator=g) + 0.5, real=False)
        >>> print(f"{float(metric.compute()):.4f}")
        34.4161
    """

    higher_is_better = False
    is_differentiable = False
    full_state_update = True
    plot_lower_bound = 0.0
    jit_compute = False

    def __init__(
        self,
        feature: Union[int, str, FeatureExtractor] = 2048,
        reset_real_features: bool = True,
        normalize: bool = False,
        cosine_distance_eps: float = 0.1,
        **kwargs: Any,
    ) -> None:
        super().__init__(feature, reset_real_features, normalize, **kwargs)
        if not (isinstance(cosine_distance_eps, float) and 1 >= cosine_distance_eps > 0):
            raise ValueError("Argument `cosine_distance_eps` expected to be a float greater than 0 and less than 1")
        self.cosine_distance_eps = cosine_distance_eps
        self.add_state("real_features", [], dist_reduce_fx=None)
        self.add_state("fake_features", [], dist_reduce_fx=None)

    def _update(self, state: Dict[str, Tensor], features: Tensor, real: bool) -> Dict[str, Tensor]:
        return {("real_features" if real else "fake_features"): features}

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        real, fake = state["real_features"], state["fake_features"]
        if isinstance(real, list) or isinstance(fake, list):
            raise RuntimeError("No real/fake features accumulated; call `update` before `compute`.")
        real64, fake64 = real.to(torch.float64), fake.to(torch.float64)
        with full_float32():
            cov_r, cov_f = torch.cov(real64.T), torch.cov(fake64.T)
        fid = _compute_fid(torch.mean(real64, dim=0), torch.atleast_2d(cov_r), torch.mean(fake64, dim=0),
                           torch.atleast_2d(cov_f))
        # the reference's argument order (real, fake): the mean over the real rows of the least
        # distance to a fake row
        distance = _cosine_distance(real, fake, self.cosine_distance_eps)
        value = torch.where(fid > 1e-8, fid / (distance + 1e-14), torch.zeros_like(fid))
        return value.to(torch.float32)


class LearnedPerceptualImagePatchSimilarity(Metric):
    """LPIPS (JAX ``generative.py:523``).

    ``net_type`` is a callable ``(img1, img2) -> (N,)`` of per-image distances, or one of the
    reference's pretrained names, which resolve through ``utils/pretrained.py`` or raise its
    no-weights ``ModuleNotFoundError``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity
        >>> net = lambda a, b: ((a - b) ** 2).mean(dim=(1, 2, 3))
        >>> metric = LearnedPerceptualImagePatchSimilarity(net_type=net, device="cpu")
        >>> metric.update(torch.zeros(2, 3, 8, 8), torch.ones(2, 3, 8, 8))
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    higher_is_better = False
    is_differentiable = True
    full_state_update = False
    plot_lower_bound = 0.0
    jit_update = False

    def __init__(
        self,
        net_type: Union[str, Callable[[Tensor, Tensor], Tensor]] = "alex",
        reduction: str = "mean",
        normalize: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if isinstance(net_type, str):
            valid_net_type = ("vgg", "alex", "squeeze")
            if net_type not in valid_net_type:
                raise ValueError(f"Argument `net_type` must be one of {valid_net_type}, but got {net_type}.")
            from torchmetrics_tpu_torch.utils.pretrained import lpips_network

            net_type = lpips_network(net_type, device=self.device)
        if not callable(net_type):
            raise ValueError("Argument `net_type` must be a string or callable")
        self.net = net_type
        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        self.reduction = reduction
        if not isinstance(normalize, bool):
            raise ValueError(f"Argument `normalize` must be an bool but got {normalize}")
        self.normalize = normalize
        self.add_state("sum_scores", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def _update(self, state: Dict[str, Tensor], img1: Tensor, img2: Tensor) -> Dict[str, Tensor]:
        if self.normalize:  # [0, 1] -> [-1, 1], the learned nets' domain
            img1 = 2 * img1 - 1
            img2 = 2 * img2 - 1
        loss = torch.as_tensor(self.net(img1, img2), dtype=torch.float32, device=self.device).reshape(-1)
        return {"sum_scores": state["sum_scores"] + torch.sum(loss), "total": state["total"] + loss.shape[0]}

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        if self.reduction == "mean":
            return state["sum_scores"] / state["total"]
        return state["sum_scores"]


def _interpolate_latents(latents1: Tensor, latents2: Tensor, epsilon: float, method: str) -> Tensor:
    """Latent-path interpolation (JAX ``generative.py:590``)."""
    eps = 1e-7
    if latents1.shape != latents2.shape:
        raise ValueError("Latents must have the same shape.")
    if method == "lerp":
        return latents1 + (latents2 - latents1) * epsilon
    if method in ("slerp_any", "slerp_unit"):
        l1n = latents1 / torch.clamp(torch.linalg.vector_norm(latents1, dim=-1, keepdim=True), min=eps)
        l2n = latents2 / torch.clamp(torch.linalg.vector_norm(latents2, dim=-1, keepdim=True), min=eps)
        d = torch.sum(l1n * l2n, dim=-1, keepdim=True)
        degenerate = (d > 1 - eps) | (d < -1 + eps)
        omega = torch.arccos(torch.clamp(d, -1.0, 1.0))
        denom = torch.clamp(torch.sin(omega), min=eps)
        out = (torch.sin((1 - epsilon) * omega) / denom) * latents1 + (torch.sin(epsilon * omega) / denom) * latents2
        lerp = latents1 + (latents2 - latents1) * epsilon
        out = torch.where(degenerate, lerp, out)
        if method == "slerp_unit":
            out = out / torch.clamp(torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=eps)
        return out
    raise ValueError(f"Interpolation method {method} not supported. Choose from 'lerp', 'slerp_any', 'slerp_unit'.")


def _lower_quantile_index(q: float, n: int) -> int:
    """The index that ``jnp.quantile(x, q, method="lower")`` takes in the sorted ``x`` of ``n``:
    ``floor(q·(n − 1))`` computed in float32, as JAX computes it, clamped to the array."""
    return min(max(int(np.floor(np.float32(q) * np.float32(n - 1))), 0), n - 1)


def perceptual_path_length(
    generator: Any,
    num_samples: int = 10_000,
    conditional: bool = False,
    batch_size: int = 64,
    interpolation_method: str = "lerp",
    epsilon: float = 1e-4,
    lower_discard: Optional[float] = 0.01,
    upper_discard: Optional[float] = 0.99,
    sim_net: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
    seed: int = 0,
    device: Union[str, torch.device, None] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Perceptual path length of a generator (JAX ``generative.py:613``): (mean, std, kept distances).

    ``generator`` needs ``sample(num_samples) -> (N, z)`` latents and ``__call__(z[, labels])`` giving
    images in [0, 255]; ``sim_net`` is a ``(img1, img2) -> (N,)`` perceptual distance. The latents are
    used where ``sample`` puts them, or moved to ``device`` where one is given (the class passes its
    own). The discards are JAX's ``method="lower"`` quantiles, taken from one sort.
    """
    if sim_net is None:
        raise ModuleNotFoundError(
            "perceptual_path_length requires a similarity net; pretrained LPIPS weights are not bundled"
            " in this build — pass `sim_net` as a callable `(img1, img2) -> (N,)`."
        )
    if not hasattr(generator, "sample") or not callable(generator.sample):
        raise NotImplementedError(
            "The generator must have a `sample` method with signature `sample(num_samples: int) -> Tensor` where the"
            " returned tensor has shape `(num_samples, z_size)`."
        )
    if conditional and not hasattr(generator, "num_classes"):
        raise AttributeError("The generator must have a `num_classes` attribute when `conditional=True`.")
    if not (isinstance(num_samples, int) and num_samples > 0):
        raise ValueError(f"Argument `num_samples` must be a positive integer, but got {num_samples}.")
    if not (isinstance(epsilon, float) and epsilon > 0):
        raise ValueError(f"Argument `epsilon` must be a positive float, but got {epsilon}.")
    if not (isinstance(batch_size, int) and batch_size > 0):
        raise ValueError(f"Argument `batch_size` must be a positive integer, but got {batch_size}.")
    if lower_discard is not None and not (isinstance(lower_discard, float) and 0 <= lower_discard <= 1):
        raise ValueError(
            f"Argument `lower_discard` must be a float between 0 and 1 or `None`, but got {lower_discard}."
        )
    if upper_discard is not None and not (isinstance(upper_discard, float) and 0 <= upper_discard <= 1):
        raise ValueError(
            f"Argument `upper_discard` must be a float between 0 and 1 or `None`, but got {upper_discard}."
        )

    rng = np.random.RandomState(seed)
    latent1 = torch.as_tensor(generator.sample(num_samples), device=device)
    latent2 = torch.as_tensor(generator.sample(num_samples), device=latent1.device)
    latent2 = _interpolate_latents(latent1, latent2, epsilon, interpolation_method)
    labels = torch.from_numpy(rng.randint(0, generator.num_classes, (num_samples,))).to(latent1.device) if conditional else None

    distances = []
    for i in range(math.ceil(num_samples / batch_size)):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        z = torch.cat((latent1[sl], latent2[sl]), dim=0)
        if conditional:
            outputs = generator(z, torch.cat((labels[sl], labels[sl]), dim=0))
        else:
            outputs = generator(z)
        out1, out2 = torch.tensor_split(torch.as_tensor(outputs), 2, dim=0)
        # [0, 255] -> [-1, 1], the similarity nets' domain
        sim = sim_net(2 * (out1 / 255) - 1, 2 * (out2 / 255) - 1)
        distances.append(torch.as_tensor(sim).reshape(-1) / epsilon**2)
    dist = torch.cat(distances)

    ordered = torch.sort(dist).values
    nan = torch.isnan(dist).any()  # a NaN makes JAX's quantiles NaN
    n = dist.shape[0]

    def lower_quantile(q: float) -> Tensor:
        value = ordered[_lower_quantile_index(q, n)]
        return torch.where(nan, torch.full_like(value, float("nan")), value)

    lower = lower_quantile(lower_discard) if lower_discard is not None else torch.zeros((), dtype=dist.dtype, device=dist.device)
    upper = lower_quantile(upper_discard) if upper_discard is not None else torch.max(dist)
    kept = dist[(dist >= lower) & (dist <= upper)]
    return torch.mean(kept), torch.std(kept, correction=1), kept


class PerceptualPathLength(Metric):
    """PPL (JAX ``generative.py:685``): a compute-only metric; ``update`` takes the generator.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import PerceptualPathLength
        >>> class Gen:
        ...     def sample(self, n):
        ...         return torch.randn(n, 4, generator=torch.Generator().manual_seed(n))
        ...     def __call__(self, z):
        ...         return 255 * torch.sigmoid(z[:, :3, None, None].expand(-1, 3, 4, 4))
        >>> sim = lambda a, b: ((a - b) ** 2).mean(dim=(1, 2, 3))
        >>> metric = PerceptualPathLength(num_samples=16, batch_size=8, sim_net=sim, device="cpu")
        >>> metric.update(Gen())
        >>> mean, std, kept = metric.compute()
        >>> kept.shape
        torch.Size([16])
    """

    higher_is_better = False
    is_differentiable = False
    full_state_update = True  # forward() runs the overridden update() (the generator's capture)
    jit_update = False
    jit_compute = False

    def __init__(
        self,
        num_samples: int = 10_000,
        conditional: bool = False,
        batch_size: int = 64,
        interpolation_method: str = "lerp",
        epsilon: float = 1e-4,
        lower_discard: Optional[float] = 0.01,
        upper_discard: Optional[float] = 0.99,
        sim_net: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
        seed: int = 0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.num_samples = num_samples
        self.conditional = conditional
        self.batch_size = batch_size
        self.interpolation_method = interpolation_method
        self.epsilon = epsilon
        self.lower_discard = lower_discard
        self.upper_discard = upper_discard
        self.sim_net = sim_net
        self.seed = seed
        self.add_state("_dummy", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self._generator: Any = None

    def _update(self, state: Dict[str, Tensor], generator: Any = None) -> Dict[str, Tensor]:
        return {}

    def update(self, generator: Any) -> None:  # noqa: D102
        self._generator = generator
        self._bump()

    def _compute(self, state: Dict[str, Any]) -> Tuple[Tensor, Tensor, Tensor]:
        return perceptual_path_length(
            self._generator,
            num_samples=self.num_samples,
            conditional=self.conditional,
            batch_size=self.batch_size,
            interpolation_method=self.interpolation_method,
            epsilon=self.epsilon,
            lower_discard=self.lower_discard,
            upper_discard=self.upper_discard,
            sim_net=self.sim_net,
            seed=self.seed,
            device=self.device,
        )
