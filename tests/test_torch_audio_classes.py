"""The port's 10 audio classes (``audio/``) against the JAX package's.

Each class goes through ``forward`` (each batch's value against JAX's forward), ``compute`` and
``update_batches`` (against JAX's updates one batch at a time) on the same seeded numpy signals; the
states are JAX's float32 ``sum_metric`` and ``total``. The SNR family, SDR and PIT update on the
emulated graph tier (``dispatch.EMULATE_ON_CPU``, ``fast_update``): one capture per step kind, then
replays, no fallback, the eager tier's bits. SRMR takes one argument and steps eagerly
(``jit_update_off``); PESQ and STOI raise JAX's ``ModuleNotFoundError`` at construction. Tolerances
are ``tests/test_torch_audio.py``'s: rtol 1e-5 / atol 1e-5 dB, SDR rtol 2e-5. The ``cuda`` test runs
both tiers on the card, bit-equal, within the same tolerances of the CPU:

    python -m pytest --noconftest tests/test_torch_audio_classes.py -m cuda
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.audio as pa
import torchmetrics_tpu_torch.functional.audio as pfa
from torchmetrics_tpu_torch.ops import dispatch


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import torchmetrics_tpu.audio as ja
    import torchmetrics_tpu.functional.audio as jfa

    return SimpleNamespace(audio=ja, functional=jfa, jnp=jnp)


def _batches(seed: int, shape, n_batches: int = 3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        target = rng.randn(*shape).astype(np.float32)
        preds = (target + 0.3 * rng.randn(*shape)).astype(np.float32)
        preds[::2] = preds[::2, ::-1] if len(shape) == 3 else preds[::2]  # PIT's swapped speakers
        out.append((preds, target))
    return out


SIG, SPK, SPEC = (4, 300), (4, 2, 300), (3, 9, 11, 2)
#: (class, constructor arguments (a function name for PIT's metric_func), batch shape, rtol)
CLASSES = [
    ("SignalNoiseRatio", {}, SIG, 1e-5),
    ("SignalNoiseRatio", {"zero_mean": True}, SIG, 1e-5),
    ("ScaleInvariantSignalNoiseRatio", {}, SIG, 1e-5),
    ("ScaleInvariantSignalDistortionRatio", {"zero_mean": True}, SIG, 1e-5),
    ("ComplexScaleInvariantSignalNoiseRatio", {}, SPEC, 1e-5),
    ("SourceAggregatedSignalDistortionRatio", {}, SPK, 1e-5),
    ("SourceAggregatedSignalDistortionRatio", {"scale_invariant": False}, SPK, 1e-5),
    ("SignalDistortionRatio", {"filter_length": 64}, SIG, 2e-5),
    ("SignalDistortionRatio", {"filter_length": 32, "zero_mean": True, "load_diag": 1e-3}, SIG, 2e-5),
    ("PermutationInvariantTraining", {"metric_func": "scale_invariant_signal_noise_ratio"}, SPK, 1e-5),
    ("PermutationInvariantTraining", {"metric_func": "signal_noise_ratio", "mode": "permutation-wise",
                                      "eval_func": "min", "zero_mean": True}, SPK, 1e-5),
]


def _make(name, kwargs, lib, **extra):
    kwargs = dict(kwargs)
    if "metric_func" in kwargs:
        funcs = lib.functional if isinstance(lib, SimpleNamespace) else pfa
        kwargs["metric_func"] = getattr(funcs, kwargs["metric_func"])
    module = lib.audio if isinstance(lib, SimpleNamespace) else pa
    return getattr(module, name)(**kwargs, **extra)


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("name, kwargs, shape, rtol", CLASSES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CLASSES)])
def test_class_matches_jax(jax, name, kwargs, shape, rtol):
    batches = _batches(len(name) + len(kwargs), shape)
    jm = _make(name, kwargs, jax)
    pm = _make(name, kwargs, None, device="cpu")
    for preds, target in batches:
        _close(pm(torch.from_numpy(preds), torch.from_numpy(target)), jm(jax.jnp.asarray(preds), jax.jnp.asarray(target)),
               rtol)
    _close(pm.compute(), jm.compute(), rtol)
    assert {k: v.dtype for k, v in pm.metric_state.items()} == {"sum_metric": torch.float32, "total": torch.float32}
    assert float(pm.metric_state["total"]) == float(jm.metric_state["total"])
    stacked = _make(name, kwargs, None, device="cpu")
    stacked.update_batches(torch.from_numpy(np.stack([b[0] for b in batches])),
                           torch.from_numpy(np.stack([b[1] for b in batches])))
    _close(stacked.compute(), jm.compute(), rtol)


def test_graph_tier_is_eager_bits_without_fallback(monkeypatch):
    """The graph-tier classes through ``update`` (``fast_update``), ``forward`` and ``update_batches``
    on the emulated graph tier: one capture per step kind, no fallback, the eager tier's bits."""
    stats = dispatch.STATS
    for name, kwargs, shape, _ in CLASSES:
        batches = [tuple(torch.from_numpy(x) for x in b) for b in _batches(9, shape)]
        values = {}
        for tier in ("graph", "eager"):
            monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", tier == "graph")
            m = _make(name, kwargs, None, device="cpu")
            m.fast_update = True
            stats.reset()
            out = [m(*batches[0]), m(*batches[1])]
            m.update(*batches[2])
            m.update(*batches[0])
            out.append(m.compute())
            m.update_batches(*(torch.stack(x) for x in zip(*batches)))
            out.append(m.compute())
            if tier == "graph":
                assert stats.captures == 3 and stats.replays == 5 and not stats.fallbacks, (name, stats.fallbacks)
            values[tier] = [v.numpy().tobytes() for v in out]
        assert values["graph"] == values["eager"], name


def test_pit_keyword_split(jax):
    """PIT keeps the base keywords (and the port's ``device``) and forwards the rest to ``metric_func``."""
    seen = {}

    def metric(preds, target, **kwargs):
        seen.update(kwargs)
        return pfa.signal_noise_ratio(preds, target)

    m = pa.PermutationInvariantTraining(metric, compute_with_cache=False, device="cpu", zero_mean=False, scale=2)
    assert m.kwargs == {"zero_mean": False, "scale": 2} and m.compute_with_cache is False
    m.update(*(torch.from_numpy(x) for x in _batches(3, SPK, 1)[0]))
    assert seen == {"zero_mean": False, "scale": 2}
    for kwargs in ({"eval_func": "avg"}, {"mode": "pairs"}):
        with pytest.raises(ValueError) as jerr:
            jax.audio.PermutationInvariantTraining(jax.functional.signal_noise_ratio, **kwargs)
        with pytest.raises(ValueError) as perr:
            pa.PermutationInvariantTraining(pfa.signal_noise_ratio, device="cpu", **kwargs)
        assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("norm", [False, True])
def test_srmr_class_matches_jax(jax, norm):
    """SRMR's one-argument ``update``/``forward``, eager (``jit_update_off``), against JAX's."""
    rng = np.random.RandomState(12)
    speech = [(rng.randn(1, 2304) * np.sin(np.linspace(0, 20, 2304))).astype(np.float32) for _ in range(2)]
    jm = jax.audio.SpeechReverberationModulationEnergyRatio(8000, n_cochlear_filters=4, norm=norm)
    pm = pa.SpeechReverberationModulationEnergyRatio(8000, n_cochlear_filters=4, norm=norm, device="cpu")
    _close(pm(torch.from_numpy(speech[0])), jm(jax.jnp.asarray(speech[0])), 1e-6)
    pm.update(torch.from_numpy(speech[1]))
    jm.update(jax.jnp.asarray(speech[1]))
    _close(pm.compute(), jm.compute(), 1e-6)
    assert float(pm.metric_state["total"]) == 2
    assert pa.SpeechReverberationModulationEnergyRatio.jit_update is False
    for kwargs in ({"fs": 0}, {"fs": 8000, "norm": "yes"}):
        with pytest.raises(ValueError) as jerr:
            jax.audio.SpeechReverberationModulationEnergyRatio(**kwargs)
        with pytest.raises(ValueError) as perr:
            pa.SpeechReverberationModulationEnergyRatio(device="cpu", **kwargs)
        assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("name, args", [("PerceptualEvaluationSpeechQuality", (8000, "nb")),
                                        ("ShortTimeObjectiveIntelligibility", (8000,))])
def test_pesq_and_stoi_raise_at_construction(jax, name, args):
    from torchmetrics_tpu_torch.functional.audio import deps

    if deps._PESQ_AVAILABLE or deps._PYSTOI_AVAILABLE:
        pytest.skip("pesq or pystoi is installed here")
    with pytest.raises(ModuleNotFoundError) as jerr:
        getattr(jax.audio, name)(*args)
    with pytest.raises(ModuleNotFoundError) as perr:
        getattr(pa, name)(*args, device="cpu")
    assert str(perr.value) == str(jerr.value)
    assert getattr(pa, name).jit_update is False and getattr(pa, name).scan_update is False


@pytest.mark.cuda
def test_classes_on_the_card_both_tiers(monkeypatch):
    """On the card: the graph-tier classes on both tiers, bit-equal, within the tolerances of the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    device = torch.device("cuda", 0)
    for name, kwargs, shape, rtol in CLASSES:
        batches = _batches(11, shape)
        cpu = _make(name, kwargs, None, device="cpu")
        for b in batches:
            cpu.update(*(torch.from_numpy(x) for x in b))
        bits = {}
        for tier in ("graph", "eager"):
            if tier == "eager":
                monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
            m = _make(name, kwargs, None, device=device)
            m.fast_update = True
            for b in batches:
                m.update(*(torch.from_numpy(x).to(device) for x in b))
            value = m.compute()
            bits[tier] = value.cpu().numpy().tobytes()
            _close(value.cpu(), cpu.compute(), rtol)
        monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH)
        assert bits["graph"] == bits["eager"], name
