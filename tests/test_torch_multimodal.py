"""The port's CLIP metrics (``functional/multimodal/clip.py``, ``multimodal/clip.py``) against the JAX
package's.

Both packages get the same pair of tiny in-process encoders (a fixed projection of the pixels, a word-hash
text embedding), returning numpy features: ``clip_score`` and ``clip_image_quality_assessment`` over their
options (single images, lists, batched arrays, custom prompt pairs, ``data_range``), both classes through
``forward`` and ``compute``, within 1e-6 (the 100-scaled scores within 1e-6 relative), and every error with
JAX's message. The HuggingFace defaults are tested only for JAX's error, with no transformers import and no
network probe.
"""
from __future__ import annotations

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.functional.multimodal as pfm
import torchmetrics_tpu_torch.multimodal as pm

D = 6
_W = np.random.RandomState(11).randn(3 * 8 * 8, D).astype(np.float32)
_WORDS = np.random.RandomState(12).randn(64, D).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def image_encoder(images):
    arr = np.stack([_np(i).astype(np.float32) for i in images]) if isinstance(images, list) else _np(images)
    return arr.reshape(arr.shape[0], -1).astype(np.float32) @ _W


def text_encoder(text):
    return np.stack([_WORDS[[sum(map(ord, w)) % 64 for w in t.split()] or [0]].mean(0) for t in text])


ENCODERS = (image_encoder, text_encoder)


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu.functional.multimodal as jfm
    import torchmetrics_tpu.multimodal as jm

    return SimpleNamespace(functional=jfm, classes=jm)


def _close(got, want, tol=1e-6):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key], tol)
        return
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _images(seed: int, n: int, dtype=np.uint8):
    rng = np.random.RandomState(seed)
    if dtype == np.uint8:
        return rng.randint(0, 256, (n, 3, 8, 8)).astype(np.uint8)
    return rng.rand(n, 3, 8, 8).astype(np.float32)


def _captions(seed: int, n: int):
    rng = np.random.RandomState(seed)
    words = ["a", "cat", "dog", "on", "the", "mat", "red", "photo", "of", "two"]
    return [" ".join(rng.choice(words, rng.randint(1, 6))) for _ in range(n)]


@pytest.mark.parametrize("form", ["list", "batched", "single"])
def test_clip_score_matches_jax(jax, form):
    imgs, caps = _images(0, 5), _captions(0, 5)
    if form == "list":
        args_j, args_p = ([i for i in imgs], caps), ([torch.from_numpy(i) for i in imgs], caps)
    elif form == "batched":
        args_j, args_p = (imgs, caps), (torch.from_numpy(imgs), caps)
    else:
        args_j, args_p = (imgs[0], caps[0]), (torch.from_numpy(imgs[0]), caps[0])
    want = jax.functional.clip_score(*args_j, model_name_or_path=ENCODERS)
    got = pfm.clip_score(*args_p, model_name_or_path=ENCODERS, device="cpu")
    _close(got, want)


@pytest.mark.parametrize("prompts, data_range", [
    (("quality",), 1.0), (("quality", "brightness", ("Good photo.", "Bad photo.")), 1.0),
    (("sharpness", ("a", "b"), ("c d", "e")), 255), (("relaxing",), 2.5),
], ids=["one prompt", "three prompts", "custom pairs, 255", "data_range 2.5"])
def test_clip_iqa_matches_jax(jax, prompts, data_range):
    imgs = _images(1, 4, np.float32) * data_range
    want = jax.functional.clip_image_quality_assessment(imgs, ENCODERS, data_range, prompts)
    got = pfm.clip_image_quality_assessment(torch.from_numpy(imgs), ENCODERS, data_range, prompts, device="cpu")
    _close(got, want)
    one = pfm.clip_image_quality_assessment(torch.from_numpy(imgs[:1]), ENCODERS, data_range, prompts, device="cpu")
    _close(one, jax.functional.clip_image_quality_assessment(imgs[:1], ENCODERS, data_range, prompts))


def _raises_alike(theirs, ours):
    with pytest.raises(Exception) as want:
        theirs()
    with pytest.raises(want.type) as got:
        ours()
    assert str(got.value) == str(want.value)


def _hf_off(monkeypatch):
    import torchmetrics_tpu.utils.pretrained as jpre

    import torchmetrics_tpu_torch.utils.pretrained as ppre

    for mod in (jpre, ppre):
        monkeypatch.setattr(mod, "_TRANSFORMERS_AVAILABLE", False)
        monkeypatch.setattr(mod, "_hub_reachable", lambda: False)
    monkeypatch.setitem(sys.modules, "transformers", None)


CLIP_ERRORS = [
    ("4-D image in a list", "score", lambda imgs, caps: ([imgs], caps[:1]), {}),
    ("more captions than images", "score", lambda imgs, caps: (list(imgs[:2]), caps[:3]), {}),
    ("model is not a pair", "score", lambda imgs, caps: (list(imgs[:1]), caps[:1]), {"model_name_or_path": 3}),
    ("HF default, no transformers", "score", lambda imgs, caps: (list(imgs[:1]), caps[:1]), {"model_name_or_path": None}),
    ("prompts not a tuple", "iqa", lambda imgs, caps: (imgs,), {"prompts": ["quality"]}),
    ("unknown prompt", "iqa", lambda imgs, caps: (imgs,), {"prompts": ("vibes",)}),
    ("prompt pair of three", "iqa", lambda imgs, caps: (imgs,), {"prompts": (("a", "b", "c"),)}),
    ("prompt of another type", "iqa", lambda imgs, caps: (imgs,), {"prompts": (3,)}),
    ("clip_iqa default", "iqa", lambda imgs, caps: (imgs,), {"model_name_or_path": "clip_iqa"}),
    ("data_range 0", "iqa", lambda imgs, caps: (imgs,), {"data_range": 0}),
    ("3-D images", "iqa", lambda imgs, caps: (imgs[0],), {}),
]


@pytest.mark.parametrize("case, kind, args, kwargs", CLIP_ERRORS, ids=[c[0] for c in CLIP_ERRORS])
def test_clip_errors_match_jax(jax, monkeypatch, case, kind, args, kwargs):
    _hf_off(monkeypatch)
    imgs, caps = _images(2, 3, np.float32), _captions(2, 3)
    kw = {"model_name_or_path": ENCODERS, **kwargs}
    if kw["model_name_or_path"] is None:
        del kw["model_name_or_path"]
    a = args(imgs, caps)
    if kind == "score":
        _raises_alike(lambda: jax.functional.clip_score(*a, **kw),
                      lambda: pfm.clip_score(*(torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in a),
                                             device="cpu", **kw))
        if case == "HF default, no transformers":
            _raises_alike(lambda: jax.classes.CLIPScore(), lambda: pm.CLIPScore(device="cpu"))
    else:
        _raises_alike(lambda: jax.functional.clip_image_quality_assessment(*a, **kw),
                      lambda: pfm.clip_image_quality_assessment(*(torch.from_numpy(x) for x in a), device="cpu", **kw))
        if case not in ("3-D images",):
            _raises_alike(lambda: jax.classes.CLIPImageQualityAssessment(**kw),
                          lambda: pm.CLIPImageQualityAssessment(device="cpu", **kw))


def test_clip_score_class_matches_jax(jax):
    """Sum and count states (the port's count int64), ``forward``'s batch value, ``compute`` over every
    batch."""
    ours, theirs = pm.CLIPScore(ENCODERS, device="cpu"), jax.classes.CLIPScore(ENCODERS)
    for seed in range(3):
        imgs, caps = _images(10 + seed, 4), _captions(10 + seed, 4)
        _close(ours(list(torch.from_numpy(imgs)), caps), theirs(list(imgs), caps))
    _close(ours.compute(), theirs.compute())
    assert ours.metric_state["n_samples"].dtype == torch.int64 and int(ours.metric_state["n_samples"]) == 12


@pytest.mark.parametrize("prompts", [("quality",), ("quality", ("Good photo.", "Bad photo."))], ids=["one", "two"])
def test_clip_iqa_class_matches_jax(jax, prompts):
    ours = pm.CLIPImageQualityAssessment(ENCODERS, data_range=2.0, prompts=prompts, device="cpu")
    theirs = jax.classes.CLIPImageQualityAssessment(ENCODERS, data_range=2.0, prompts=prompts)
    with pytest.raises(RuntimeError, match="No images accumulated"), pytest.warns(UserWarning, match="before"):
        ours.compute()
    for seed in range(3):
        imgs = _images(20 + seed, 3, np.float32) * 2
        _close(ours(torch.from_numpy(imgs)), theirs(imgs))
    _close(ours.compute(), theirs.compute())


def test_clip_metrics_default_to_cuda(monkeypatch):
    from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    imgs, caps = torch.from_numpy(_images(3, 2)), _captions(3, 2)
    calls = [lambda **kw: pm.CLIPScore(ENCODERS, **kw), lambda **kw: pm.CLIPImageQualityAssessment(ENCODERS, **kw),
             lambda **kw: pfm.clip_score(list(imgs), caps, ENCODERS, **kw),
             lambda **kw: pfm.clip_image_quality_assessment(imgs.float(), ENCODERS, **kw)]
    for call in calls:
        with pytest.raises(TorchMetricsUserError, match="device='cpu'"):
            call()
        assert call(device="cpu").device == torch.device("cpu")
