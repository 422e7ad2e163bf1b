"""The port's 12 image-quality classes (``image/``) against the JAX package's.

Each class over its options goes through ``forward`` (each batch's value against JAX's forward),
``compute``, and ``update_batches`` (against JAX's updates one batch at a time), on the same seeded
numpy images; the states keep JAX's names, reductions and kinds (scalar sums or ``cat`` lists), in
float32, with TV's image count in int64. On the emulated graph tier (``dispatch.EMULATE_ON_CPU``)
the scalar-state classes capture one graph per step kind and replay it, with no fallback, and give
the eager tier's bits; the list-state classes step eagerly (fallback ``list_state``) with the same
bits. Tolerances are those of ``tests/test_torch_image.py``: rtol 1e-5 / atol 1e-6, and 1e-5
absolute for the windowed means (SSIM, MS-SSIM, UQI, VIF). The ``cuda`` test runs both tiers on
the card, bit-equal, and holds them to the CPU within the same tolerances:

    python -m pytest --noconftest tests/test_torch_image_classes.py -m cuda
"""
from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.image as pi
from torchmetrics_tpu_torch.ops import dispatch

WINDOWED = {"StructuralSimilarityIndexMeasure", "MultiScaleStructuralSimilarityIndexMeasure",
            "UniversalImageQualityIndex", "VisualInformationFidelity"}


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu.image as ji

    return SimpleNamespace(image=ji)


def _batches(seed: int, shape, n_batches: int = 3, noise: float = 0.1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        target = rng.rand(*shape).astype(np.float32)
        preds = np.clip(target + noise * rng.randn(*shape), 0, 1).astype(np.float32)
        out.append((preds, target))
    return out


RGB, GRAY, BANDS, VOL = (2, 3, 48, 48), (2, 1, 48, 48), (2, 5, 32, 32), (2, 2, 12, 14, 16)
#: (class, constructor arguments, batch shape)
CLASSES = [
    ("StructuralSimilarityIndexMeasure", {"data_range": 1.0}, RGB),
    ("StructuralSimilarityIndexMeasure", {}, RGB),
    ("StructuralSimilarityIndexMeasure", {"reduction": "sum", "gaussian_kernel": False, "kernel_size": 7}, RGB),
    ("StructuralSimilarityIndexMeasure", {"reduction": "none", "data_range": (0.1, 0.9)}, RGB),
    ("StructuralSimilarityIndexMeasure", {"return_contrast_sensitivity": True, "data_range": 1.0}, RGB),
    ("StructuralSimilarityIndexMeasure", {"return_full_image": True, "reduction": "none"}, GRAY),
    ("StructuralSimilarityIndexMeasure", {"sigma": 0.8, "kernel_size": 7, "data_range": 1.0}, VOL),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"betas": (0.5, 0.5), "data_range": 1.0}, RGB),
    ("MultiScaleStructuralSimilarityIndexMeasure", {"betas": (0.3, 0.3, 0.4), "reduction": "none",
                                                    "normalize": "simple"}, RGB),
    ("PeakSignalNoiseRatio", {}, RGB),
    ("PeakSignalNoiseRatio", {"data_range": 1.0, "base": 2.0}, RGB),
    ("PeakSignalNoiseRatio", {"data_range": (0.1, 0.7)}, RGB),
    ("PeakSignalNoiseRatio", {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}, RGB),
    ("PeakSignalNoiseRatioWithBlockedEffect", {}, GRAY),
    ("PeakSignalNoiseRatioWithBlockedEffect", {"block_size": 5}, GRAY),
    ("UniversalImageQualityIndex", {}, RGB),
    ("UniversalImageQualityIndex", {"reduction": "sum", "kernel_size": (5, 7), "sigma": (1.0, 2.0)}, RGB),
    ("UniversalImageQualityIndex", {"reduction": "none"}, GRAY),
    ("SpectralAngleMapper", {}, BANDS),
    ("SpectralAngleMapper", {"reduction": "sum"}, RGB),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {}, BANDS),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {"ratio": 2, "reduction": "none"}, RGB),
    ("RelativeAverageSpectralError", {}, RGB),
    ("RelativeAverageSpectralError", {"window_size": 5}, BANDS),
    ("RootMeanSquaredErrorUsingSlidingWindow", {}, RGB),
    ("RootMeanSquaredErrorUsingSlidingWindow", {"window_size": 7}, GRAY),
    ("SpectralDistortionIndex", {}, BANDS),
    ("SpectralDistortionIndex", {"p": 2, "reduction": "sum"}, BANDS),
    ("TotalVariation", {}, RGB),
    ("TotalVariation", {"reduction": "mean"}, RGB),
    ("TotalVariation", {"reduction": "none"}, GRAY),
    ("VisualInformationFidelity", {}, RGB),
]
IDS = [f"{c[0]}-{i}" for i, c in enumerate(CLASSES)]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _leaves(value):
    if isinstance(value, (tuple, list)):
        return [leaf for v in value for leaf in _leaves(v)]
    return [value]


def _close(name: str, ours, theirs) -> None:
    ours, theirs = _leaves(ours), _leaves(theirs)
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        t = np.asarray(t)
        assert o.dtype == torch.float32 and tuple(o.shape) == t.shape, (o.dtype, o.shape, t.shape)
        atol = 1e-5 if name in WINDOWED else 1e-6
        np.testing.assert_allclose(o.numpy(), t, rtol=1e-5, atol=atol, equal_nan=True)


def _args(name: str, batch):
    return batch[:1] if name == "TotalVariation" else batch


def _make(ns, name, kwargs, **device):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # PSNR's note on ``reduction`` without ``dim``
        return getattr(ns, name)(**kwargs, **device)


@pytest.mark.parametrize("name,kwargs,shape", CLASSES, ids=IDS)
def test_forward_and_compute_match_jax(jax, name, kwargs, shape):
    ours, theirs = _make(pi, name, kwargs, device="cpu"), _make(jax.image, name, kwargs)
    for batch in _batches(len(name) + len(kwargs), shape, n_batches=2):
        _close(name, ours(*_t(*_args(name, batch))), theirs(*_args(name, batch)))
    _close(name, ours.compute(), theirs.compute())
    theirs_state = theirs.metric_state
    for key, value in ours.metric_state.items():
        assert key in theirs_state
        assert isinstance(value, list) == isinstance(theirs_state[key], list), key
        for entry in value if isinstance(value, list) else [value]:
            assert entry.dtype == (torch.int64 if key == "num_elements" else torch.float32), key
    assert ours._reductions == theirs._reductions


@pytest.mark.parametrize("name,kwargs,shape", CLASSES[::3], ids=IDS[::3])
def test_update_batches_matches_jax(jax, name, kwargs, shape):
    batches = _batches(len(name) + 7, shape, n_batches=3)
    ours, theirs = _make(pi, name, kwargs, device="cpu"), _make(jax.image, name, kwargs)
    ours.update_batches(*_t(*(np.stack(x) for x in zip(*(_args(name, b) for b in batches)))))
    for batch in batches:
        theirs.update(*_args(name, batch))
    _close(name, ours.compute(), theirs.compute())


@pytest.fixture
def graph_tier(monkeypatch):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)
    dispatch.STATS.reset()
    return dispatch.STATS


def _run(name, kwargs, batches, device, fast_update: bool):
    """Two forwards, an update, a compute, then ``update_batches`` of the stack and a compute."""
    m = _make(pi, name, kwargs, device=device)
    m.fast_update = fast_update
    values = [m(*(b.to(device) for b in batch)) for batch in batches[:2]]
    m.update(*(b.to(device) for b in batches[2]))
    values.append(m.compute())
    m.reset()
    m.update_batches(*(torch.stack([b[i] for b in batches]).to(device) for i in range(len(batches[0]))))
    values.append(m.compute())
    return [v.cpu() for v in _leaves(values)]


@pytest.mark.parametrize("name,kwargs,shape", CLASSES, ids=IDS)
def test_graph_tier_equals_eager(graph_tier, monkeypatch, name, kwargs, shape):
    batches = [tuple(_t(*_args(name, b))) for b in _batches(3, shape, n_batches=3)]
    graph = _run(name, kwargs, batches, "cpu", fast_update=True)
    lists = bool(_make(pi, name, kwargs, device="cpu")._lists)
    reasons = {key[1:] for key in graph_tier.fallbacks}
    if lists:
        assert graph_tier.captures == 0 and reasons <= {("forward", "not_fusable"), ("update", "list_state"),
                                                        ("update_batches", "list_state")}
    else:
        # forward, update and update_batches: one capture each, then replays; no fallback
        assert graph_tier.captures == 3 and graph_tier.replays == 4 and not reasons
    monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
    eager = _run(name, kwargs, batches, "cpu", fast_update=True)
    assert [v.numpy().tobytes() for v in graph] == [v.numpy().tobytes() for v in eager]


@pytest.mark.cuda
def test_graph_tier_equals_eager_on_the_card(monkeypatch):
    """On the card: SSIM, MS-SSIM, PSNR, PSNR-B, UQI, RMSE-SW, TV and VIF on the graph tier equal
    their eager tier bit for bit, and agree with the CPU within the stated tolerances."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph tier captures CUDA graphs")
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", False)
    card = torch.device("cuda", 0)
    for name, kwargs, shape in CLASSES:
        if name in ("RelativeAverageSpectralError", "ErrorRelativeGlobalDimensionlessSynthesis"):
            continue
        batches = [tuple(_t(*_args(name, b))) for b in _batches(3, shape, n_batches=3)]
        monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)
        graph = _run(name, kwargs, batches, card, fast_update=True)
        monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
        eager = _run(name, kwargs, batches, card, fast_update=True)
        cpu = _run(name, kwargs, batches, "cpu", fast_update=True)
        assert [v.numpy().tobytes() for v in graph] == [v.numpy().tobytes() for v in eager], name
        _close(name, graph, cpu)
