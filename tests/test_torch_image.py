"""The port's functional image-quality entries (``functional/image``) against the JAX package's.

The same seeded numpy images go through both packages on the CPU, over the entries' options: SSIM
in 2-D and 3-D, with the uniform kernel (padded from the gaussian's support, as in JAX), asymmetric
sigmas and kernels, ``data_range`` as None, a float and a tuple, ``k1``/``k2``, every reduction,
``return_full_image`` and ``return_contrast_sensitivity``; MS-SSIM's betas and ``normalize``; UQI's
kernels; PSNR's ``data_range``, ``dim`` and ``base``; PSNR-B's block sizes, its ``data_range > 2``
branch and its channel check; SAM, ERGAS; RMSE-SW's and RASE's windows, odd and even; D-lambda with
one band and with ``p``; VIF; TV; image gradients; and each error message. The reflect pad on
images smaller than the pad (numpy reflects again where ``F.pad`` raises) is held to ``jnp.pad``,
and to JAX's SSIM and UQI on such an image.

Images are at most 2 x 3 x 48 x 48 (3-D: 2 x 2 x 12 x 14 x 16), made once per module, and the JAX
side of each value is one ``jax.jit`` of the entry (one compile per case, where eager JAX compiles
every operation of it). Values agree within rtol 1e-5 / atol 1e-6, except: SSIM, MS-SSIM, UQI and VIF
maps and means within 1e-5 absolute, their sums within 1e-5 relative (float32 sums of window moments in
another order; JAX's own tests allow these 1e-4, ``tests/unittests/image/test_image.py:56``), RASE, whose
values are about 5,000, within rtol 1e-5 alone, and SAM's per-pixel angles (``reduction="none"``)
within ``(2C + 6)·2^-24·|cot θ|``: the float32 rounding of ``cos θ`` over ``C`` bands, which
``arccos`` magnifies where the angle is small. A caller's ``set_float32_matmul_precision``
("high") changes no bit of any entry and is left as it was.
"""
from __future__ import annotations

import re
import warnings
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.functional as pf
from torchmetrics_tpu_torch.functional.image import helpers

RTOL, ATOL = 1e-5, 1e-6
#: entries whose value is a mean of window statistics (JAX's own tests allow 1e-4)
WINDOWED = {"structural_similarity_index_measure", "multiscale_structural_similarity_index_measure",
            "universal_image_quality_index", "visual_information_fidelity"}


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    import torchmetrics_tpu.functional as jf
    import torchmetrics_tpu.functional.image.helpers as jhelpers

    return SimpleNamespace(f=jf, jnp=jnp, helpers=jhelpers, jit=jax.jit)


def _images(seed: int, shape=(2, 3, 48, 48), noise: float = 0.1, scale: float = 1.0):
    rng = np.random.RandomState(seed)
    target = rng.rand(*shape).astype(np.float32)
    preds = np.clip(target + noise * rng.randn(*shape), 0, 1).astype(np.float32)
    return preds * np.float32(scale), target * np.float32(scale)


DATA = {
    "rgb": _images(0),
    "rgb255": _images(1, scale=255.0),
    "gray": _images(2, shape=(2, 1, 48, 48)),
    "bands": _images(3, shape=(2, 5, 32, 32), noise=0.05),
    "one_band": _images(4, shape=(2, 1, 32, 32)),
    "vol": _images(5, shape=(2, 2, 12, 14, 16)),
    "tiny": _images(6, shape=(1, 2, 4, 5)),
}


def _leaves(value):
    return list(value) if isinstance(value, (tuple, list)) else [value]


def _sam_bound(theirs: np.ndarray, channels: int) -> np.ndarray:
    """An angle's float32 error: ``cos θ`` carries about ``(2C + 6)`` roundings (the dot product, the
    two norms, their product and the quotient), which ``arccos`` scales by ``1 / sin θ``."""
    return (2 * channels + 6) * 2.0**-24 * np.abs(np.cos(theirs)) / np.maximum(np.sin(theirs), 1e-6) + ATOL


def _close(name: str, ours, theirs, channels: int = 0) -> None:
    ours, theirs = _leaves(ours), _leaves(theirs)
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        t = np.asarray(t)
        assert tuple(o.shape) == t.shape, (o.shape, t.shape)
        assert o.dtype == torch.float32
        if name in WINDOWED:
            np.testing.assert_allclose(o.numpy(), t, rtol=RTOL, atol=1e-5, equal_nan=True)
        elif name == "spectral_angle_mapper" and t.ndim:
            assert np.all(np.abs(o.numpy().astype(np.float64) - t) <= _sam_bound(t.astype(np.float64), channels))
        elif name == "relative_average_spectral_error":
            np.testing.assert_allclose(o.numpy(), t, rtol=RTOL, equal_nan=True)
        else:
            np.testing.assert_allclose(o.numpy(), t, rtol=RTOL, atol=ATOL, equal_nan=True)


#: (entry, data, keyword arguments)
CASES = [
    ("structural_similarity_index_measure", "rgb", {}),
    ("structural_similarity_index_measure", "rgb", {"data_range": 1.0}),
    ("structural_similarity_index_measure", "rgb", {"data_range": (0.2, 0.8)}),
    ("structural_similarity_index_measure", "rgb255", {"data_range": 255.0, "k1": 0.02, "k2": 0.05}),
    ("structural_similarity_index_measure", "rgb", {"gaussian_kernel": False, "kernel_size": 7}),
    ("structural_similarity_index_measure", "rgb", {"sigma": (1.0, 2.0), "kernel_size": (7, 9)}),
    ("structural_similarity_index_measure", "rgb", {"reduction": "none"}),
    ("structural_similarity_index_measure", "rgb", {"reduction": "sum", "data_range": 1.0}),
    ("structural_similarity_index_measure", "rgb", {"return_full_image": True, "data_range": 1.0}),
    ("structural_similarity_index_measure", "rgb", {"return_contrast_sensitivity": True, "reduction": "none"}),
    ("structural_similarity_index_measure", "gray", {"data_range": 1.0}),
    ("structural_similarity_index_measure", "vol", {"sigma": 0.8, "kernel_size": 7}),
    ("structural_similarity_index_measure", "vol", {"gaussian_kernel": False, "kernel_size": (3, 5, 3), "sigma": 0.8,
                                                   "data_range": 1.0}),
    ("structural_similarity_index_measure", "tiny", {}),
    ("multiscale_structural_similarity_index_measure", "rgb", {"betas": (0.5, 0.5), "data_range": 1.0}),
    ("multiscale_structural_similarity_index_measure", "rgb", {"betas": (0.3, 0.3, 0.4)}),
    ("multiscale_structural_similarity_index_measure", "rgb", {"betas": (0.3, 0.3, 0.4), "normalize": "simple",
                                                              "reduction": "none"}),
    ("multiscale_structural_similarity_index_measure", "rgb", {"betas": (0.5, 0.5), "normalize": None,
                                                              "reduction": "sum", "data_range": (0.1, 0.9)}),
    ("multiscale_structural_similarity_index_measure", "gray", {"kernel_size": 3, "gaussian_kernel": False,
                                                               "sigma": 0.5}),
    ("universal_image_quality_index", "rgb", {}),
    ("universal_image_quality_index", "rgb", {"kernel_size": (5, 7), "sigma": (1.0, 2.0), "reduction": "none"}),
    ("universal_image_quality_index", "gray", {"reduction": "sum"}),
    ("universal_image_quality_index", "tiny", {}),
    ("peak_signal_noise_ratio", "rgb", {}),
    ("peak_signal_noise_ratio", "rgb", {"data_range": 1.0, "base": 2.0}),
    ("peak_signal_noise_ratio", "rgb", {"data_range": (0.1, 0.7)}),
    ("peak_signal_noise_ratio", "rgb", {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}),
    ("peak_signal_noise_ratio", "rgb", {"data_range": 1.0, "dim": 1, "reduction": "sum"}),
    ("peak_signal_noise_ratio", "rgb255", {"data_range": 255.0, "dim": (2, 3)}),
    ("peak_signal_noise_ratio_with_blocked_effect", "gray", {}),
    ("peak_signal_noise_ratio_with_blocked_effect", "gray", {"block_size": 5}),
    ("peak_signal_noise_ratio_with_blocked_effect", "rgb255", "luma"),
    ("spectral_angle_mapper", "rgb", {}),
    ("spectral_angle_mapper", "bands", {"reduction": "none"}),
    ("spectral_angle_mapper", "bands", {"reduction": "sum"}),
    ("error_relative_global_dimensionless_synthesis", "bands", {}),
    ("error_relative_global_dimensionless_synthesis", "rgb", {"ratio": 2, "reduction": "none"}),
    ("root_mean_squared_error_using_sliding_window", "rgb", {}),
    ("root_mean_squared_error_using_sliding_window", "rgb", {"window_size": 7, "return_rmse_map": True}),
    ("root_mean_squared_error_using_sliding_window", "gray", {"window_size": 4, "return_rmse_map": True}),
    ("relative_average_spectral_error", "rgb", {}),
    ("relative_average_spectral_error", "bands", {"window_size": 5}),
    ("spectral_distortion_index", "bands", {}),
    ("spectral_distortion_index", "bands", {"p": 2, "reduction": "sum"}),
    ("spectral_distortion_index", "rgb", {"p": 3}),
    ("spectral_distortion_index", "one_band", {}),
    ("visual_information_fidelity", "rgb", {}),
    ("visual_information_fidelity", "rgb", {"sigma_n_sq": 0.5}),
]


def _args(data: str, kwargs):
    preds, target = DATA[data]
    if kwargs == "luma":  # one channel of a 0-255 image: the data_range > 2 branch
        return (preds[:, :1], target[:, :1]), {}
    return (preds, target), kwargs


@pytest.mark.parametrize("name,data,kwargs", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_entry_matches_jax(jax, name, data, kwargs):
    args, kwargs = _args(data, kwargs)
    ours = getattr(pf, name)(*(torch.from_numpy(a) for a in args), **kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # PSNR's note on ``reduction`` without ``dim``
        theirs = jax.jit(partial(getattr(jax.f, name), **kwargs))(*args)
    _close(name, ours, theirs, channels=args[0].shape[1])


@pytest.mark.parametrize("data", ["rgb", "gray"])
@pytest.mark.parametrize("reduction", ["sum", "mean", "none", None])
def test_total_variation_matches_jax(jax, data, reduction):
    img = DATA[data][0]
    _close("total_variation", pf.total_variation(torch.from_numpy(img), reduction), jax.f.total_variation(img, reduction))


@pytest.mark.parametrize("dtype", [np.float32, np.int64])
def test_image_gradients_match_jax(jax, dtype):
    img = (DATA["rgb"][0] * 100).astype(dtype)
    ours = pf.image_gradients(torch.from_numpy(img))
    for o, t in zip(ours, jax.f.image_gradients(img)):
        np.testing.assert_array_equal(o.numpy(), np.asarray(t))


@pytest.mark.parametrize("n,pad", [(1, 3), (2, 2), (3, 5), (4, 5), (5, 11), (9, 4)])
def test_reflect_pad_on_small_axes_matches_jnp_pad(jax, n, pad):
    """Numpy's ``reflect`` reflects again where the pad is not smaller than the axis; ``F.pad`` raises."""
    x = np.arange(2 * 3 * n * (n + 1), dtype=np.float32).reshape(2, 3, n, n + 1)
    ours = helpers._reflect_pad(torch.from_numpy(x), pad, pad + 1)
    theirs = jax.jnp.pad(x, ((0, 0), (0, 0), (pad, pad), (pad + 1, pad + 1)), mode="reflect")
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    if pad >= n:
        with pytest.raises(RuntimeError):
            torch.nn.functional.pad(torch.from_numpy(x), (pad + 1, pad + 1, pad, pad), mode="reflect")


@pytest.mark.parametrize("n,pad,outer", [(1, 2, 1), (3, 4, 0), (4, 4, 0), (5, 2, 1), (2, 7, 1)])
def test_symmetric_pad_matches_jnp_pad(jax, n, pad, outer):
    x = np.arange(n * (n + 2), dtype=np.float32).reshape(1, 1, n, n + 2)
    ours = helpers._symmetric_pad_2d(torch.from_numpy(x), pad, outer)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax.helpers._symmetric_pad_2d(x, pad, outer)))


def _outcome(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            fn()
        except Exception as err:  # noqa: BLE001 - the exception's type and text are compared
            return type(err).__name__, re.sub(r"torch\.Size|Shape", "", str(err))
    return None


#: (entry, data, keyword arguments or a transform of the inputs) that raise in both packages
ERRORS = [
    ("structural_similarity_index_measure", "rgb", {"return_full_image": True, "return_contrast_sensitivity": True}),
    ("structural_similarity_index_measure", "rgb", {"kernel_size": 4}),
    ("structural_similarity_index_measure", "rgb", {"sigma": -1.0}),
    ("structural_similarity_index_measure", "rgb", {"kernel_size": (11, 11, 11)}),
    ("structural_similarity_index_measure", "rgb", "3d"),
    ("structural_similarity_index_measure", "rgb", "mismatch"),
    ("multiscale_structural_similarity_index_measure", "rgb", {"betas": [0.5, 0.5]}),
    ("multiscale_structural_similarity_index_measure", "rgb", {"betas": (1, 2)}),
    ("multiscale_structural_similarity_index_measure", "rgb", {"normalize": "max"}),
    ("multiscale_structural_similarity_index_measure", "rgb", {}),
    ("multiscale_structural_similarity_index_measure", "rgb", {"betas": (0.3, 0.3, 0.4), "kernel_size": 13}),
    ("universal_image_quality_index", "rgb", {"kernel_size": (5,), "sigma": (1.0, 1.0)}),
    ("universal_image_quality_index", "rgb", {"kernel_size": (4, 5)}),
    ("universal_image_quality_index", "rgb", {"sigma": (1.0, 0.0)}),
    ("universal_image_quality_index", "rgb", "3d"),
    ("peak_signal_noise_ratio", "rgb", {"dim": 1}),
    ("peak_signal_noise_ratio_with_blocked_effect", "rgb", {}),
    ("spectral_angle_mapper", "gray", {}),
    ("spectral_angle_mapper", "rgb", "3d"),
    ("spectral_angle_mapper", "rgb", "mismatch"),
    ("error_relative_global_dimensionless_synthesis", "rgb", "3d"),
    ("root_mean_squared_error_using_sliding_window", "rgb", {"window_size": 0}),
    ("root_mean_squared_error_using_sliding_window", "rgb", {"window_size": 2.5}),
    ("root_mean_squared_error_using_sliding_window", "rgb", {"window_size": 96}),
    ("root_mean_squared_error_using_sliding_window", "rgb", "3d"),
    ("relative_average_spectral_error", "rgb", {"window_size": -1}),
    ("spectral_distortion_index", "rgb", {"p": 0}),
    ("spectral_distortion_index", "rgb", {"p": 1.5}),
    ("spectral_distortion_index", "rgb", "3d"),
    ("spectral_distortion_index", "rgb", "channels"),
    ("visual_information_fidelity", "tiny", {}),
    ("total_variation", "rgb", "one_arg_3d"),
    ("image_gradients", "rgb", "one_arg_3d"),
]


@pytest.mark.parametrize("name,data,kwargs", ERRORS, ids=[f"{c[0]}-{i}" for i, c in enumerate(ERRORS)])
def test_errors_match_jax(jax, name, data, kwargs):
    preds, target = DATA[data]
    args = (preds, target)
    if kwargs == "3d":
        args, kwargs = (preds[0], target[0]), {}
    elif kwargs == "mismatch":
        args, kwargs = (preds, target[..., :-1]), {}
    elif kwargs == "channels":
        args, kwargs = (preds, target[:, :2]), {}
    elif kwargs == "one_arg_3d":
        args, kwargs = (preds[0],), {}
    ours = _outcome(lambda: getattr(pf, name)(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), **kwargs))
    theirs = _outcome(lambda: getattr(jax.f, name)(*args, **kwargs))
    assert ours is not None and ours == theirs


def test_psnr_warns_where_jax_warns(jax):
    preds, target = (torch.from_numpy(a) for a in DATA["rgb"])
    with pytest.warns(UserWarning, match="will not have any effect"):
        pf.peak_signal_noise_ratio(preds, target, reduction="sum")


def test_tf32_setting_changes_nothing_and_is_restored():
    """Under a caller's ``set_float32_matmul_precision("high")`` every convolution-based entry gives the
    bits of the default setting, and the setting reads "high" afterwards."""
    preds, target = (torch.from_numpy(a) for a in DATA["rgb"])
    bands = tuple(torch.from_numpy(a) for a in DATA["bands"])
    calls = {
        "ssim": lambda: pf.structural_similarity_index_measure(preds, target, reduction="none"),
        "ms_ssim": lambda: pf.multiscale_structural_similarity_index_measure(preds, target, betas=(0.5, 0.5)),
        "uqi": lambda: pf.universal_image_quality_index(preds, target, reduction="none"),
        "vif": lambda: pf.visual_information_fidelity(preds, target),
        "rmse_sw": lambda: pf.root_mean_squared_error_using_sliding_window(preds, target, return_rmse_map=True)[1],
        "d_lambda": lambda: pf.spectral_distortion_index(*bands),
    }
    before = {k: fn() for k, fn in calls.items()}
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        after = {k: fn() for k, fn in calls.items()}
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(old)
    for k in calls:
        assert torch.equal(before[k], after[k]), k


def test_d_lambda_blocks_of_pairs_give_the_same_values(monkeypatch):
    """D-lambda's band pairs in blocks of 3 (of 10) give the one-block values: each pair's UQI is the
    same operations on the same planes, only fewer pairs share a convolution call."""
    from torchmetrics_tpu_torch.functional.image import d_lambda

    preds, target = (torch.from_numpy(a) for a in DATA["bands"])
    whole = d_lambda._pairwise_band_uqi(target, torch.triu_indices(5, 5, offset=1))
    value = pf.spectral_distortion_index(preds, target, p=2)
    b, _, h, w = target.shape
    monkeypatch.setattr(d_lambda, "BLOCK_BYTES", 3 * d_lambda.PLANES_PER_PAIR * b * (h + 10) * (w + 10) * 4)
    assert d_lambda.block_pairs(b, h, w) == 3
    np.testing.assert_allclose(d_lambda._pairwise_band_uqi(target, torch.triu_indices(5, 5, offset=1)).numpy(),
                               whole.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pf.spectral_distortion_index(preds, target, p=2).numpy(), value.numpy(), rtol=1e-6)
