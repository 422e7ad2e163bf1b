"""The port's 11 functional audio entries (``functional/audio/``) against the JAX package's.

The same seeded numpy signals go to both. Tolerances: the SNR family within rtol 1e-5 / atol 1e-5 dB
(float32 sums of squares, reduced in another order); SDR within rtol 2e-5 (a float32 solve of a
Toeplitz system: the port's Cholesky, JAX's LU; 1.5e-4 dB on 19 dB seen), NaN for a silent target in both; PIT's permutations equal JAX's and its values as its
metric's; the permutation table equals ``itertools.permutations``; SRMR (a float64 host pipeline in
both, rounded to float32) within rtol 1e-6; every error JAX's type and message.
"""
from __future__ import annotations

import itertools
import warnings
from contextlib import nullcontext

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.functional.audio as pa
from torchmetrics_tpu_torch.functional.audio import pit as ppit
from torchmetrics_tpu_torch.functional.audio import sdr as psdr

RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def ja():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import torchmetrics_tpu.functional.audio as ja_

    return ja_, jnp


def _signals(seed: int, shape, leak: float = 0.3):
    rng = np.random.RandomState(seed)
    target = rng.randn(*shape).astype(np.float32)
    preds = (target + leak * rng.randn(*shape) + 0.1).astype(np.float32)
    return preds, target


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy().astype(np.float64), np.asarray(want, np.float64), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name, kwargs", [
    ("signal_noise_ratio", {}),
    ("signal_noise_ratio", {"zero_mean": True}),
    ("scale_invariant_signal_distortion_ratio", {}),
    ("scale_invariant_signal_distortion_ratio", {"zero_mean": True}),
    ("scale_invariant_signal_noise_ratio", {}),
    ("source_aggregated_signal_distortion_ratio", {}),
    ("source_aggregated_signal_distortion_ratio", {"scale_invariant": False, "zero_mean": True}),
])
def test_snr_family_matches_jax(ja, name, kwargs):
    jfa, jnp = ja
    preds, target = _signals(1, (3, 2, 400))
    _close(getattr(pa, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs),
           getattr(jfa, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs))


@pytest.mark.parametrize("zero_mean", [False, True])
def test_complex_si_snr_complex_and_real_view(ja, zero_mean):
    """Complex spectrograms and their ``(..., F, T, 2)`` real view give JAX's values and each other's bits."""
    jfa, jnp = ja
    preds, target = _signals(2, (2, 9, 11, 2))
    cp, ct = (torch.view_as_complex(torch.from_numpy(x)) for x in (preds, target))
    got_real = pa.complex_scale_invariant_signal_noise_ratio(torch.from_numpy(preds), torch.from_numpy(target), zero_mean)
    got_complex = pa.complex_scale_invariant_signal_noise_ratio(cp, ct, zero_mean)
    assert torch.equal(got_real, got_complex)
    want = jfa.complex_scale_invariant_signal_noise_ratio(jnp.asarray(cp.numpy()), jnp.asarray(ct.numpy()), zero_mean)
    _close(got_complex, want)


@pytest.mark.parametrize("kwargs", [{"filter_length": 64}, {"zero_mean": True, "filter_length": 64},
                                    {"load_diag": 1e-3, "filter_length": 64}])  # one width: one JAX compile
def test_sdr_matches_jax(ja, kwargs):
    jfa, jnp = ja
    rng = np.random.RandomState(3)
    target = np.cumsum(rng.randn(2, 3, 1000), axis=-1).astype(np.float32) * 0.05 + rng.randn(2, 3, 1000).astype(np.float32)
    preds = (0.8 * target + 0.2 * rng.randn(2, 3, 1000)).astype(np.float32)
    _close(pa.signal_distortion_ratio(torch.from_numpy(preds), torch.from_numpy(target), **kwargs),
           jfa.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target), **kwargs), rtol=2e-5, atol=0)


def test_sdr_of_a_silent_target_is_nan_in_both(ja):
    """A silent target makes the Toeplitz system zero: the port's unchecked Cholesky gives NaN, as JAX's
    unchecked LU does; the other row keeps its value."""
    jfa, jnp = ja
    preds, target = _signals(9, (2, 300))
    target[0] = 0.0
    got = pa.signal_distortion_ratio(torch.from_numpy(preds), torch.from_numpy(target), filter_length=64)
    want = np.asarray(jfa.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target), filter_length=64))
    assert np.isnan(float(got[0])) and np.isnan(want[0])
    _close(got[1:], want[1:], rtol=2e-5, atol=0)


def test_sdr_warns_once_for_use_cg_iter(monkeypatch):
    monkeypatch.setattr(psdr, "_warned_cg_iter", False)
    preds, target = (torch.from_numpy(x) for x in _signals(4, (200,)))
    with pytest.warns(UserWarning, match="use_cg_iter"):
        pa.signal_distortion_ratio(preds, target, use_cg_iter=10, filter_length=16)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pa.signal_distortion_ratio(preds, target, use_cg_iter=10, filter_length=16)


def test_toeplitz_and_correlations_match_jax(ja):
    _, jnp = ja
    import torchmetrics_tpu.functional.audio.sdr as jsdr

    r0 = np.random.RandomState(5).randn(2, 7).astype(np.float32)
    assert np.array_equal(psdr._symmetric_toeplitz(torch.from_numpy(r0)).numpy(), np.asarray(jsdr._symmetric_toeplitz(jnp.asarray(r0))))
    preds, target = _signals(6, (2, 300))
    for got, want in zip(psdr._compute_autocorr_crosscorr(torch.from_numpy(target), torch.from_numpy(preds), 20),
                         jsdr._compute_autocorr_crosscorr(jnp.asarray(target), jnp.asarray(preds), 20)):
        _close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("spk_num", [1, 2, 3, 4, 5])
def test_permutation_table_is_itertools(spk_num):
    table = ppit._gen_permutations(spk_num, torch.device("cpu"))
    assert table.tolist() == [list(p) for p in itertools.permutations(range(spk_num))]
    assert ppit._gen_permutations(spk_num, torch.device("cpu")) is table  # cached


@pytest.mark.parametrize("mode", ["speaker-wise", "permutation-wise"])
@pytest.mark.parametrize("eval_func, metric", [("max", "scale_invariant_signal_noise_ratio"),
                                               ("min", "signal_noise_ratio")])
def test_pit_matches_jax(ja, mode, eval_func, metric):
    """Both modes and both ``eval_func``s, with a swapped speaker order in half the samples and a
    keyword forwarded to ``metric_func``; ``pit_permutate`` by the best permutation."""
    jfa, jnp = ja
    rng = np.random.RandomState(7)
    target = rng.randn(4, 3, 200).astype(np.float32)
    preds = (target + 0.4 * rng.randn(4, 3, 200)).astype(np.float32)
    preds[::2] = preds[::2, ::-1]
    kwargs = {"zero_mean": True} if metric == "signal_noise_ratio" else {}
    best, perm = pa.permutation_invariant_training(torch.from_numpy(preds), torch.from_numpy(target),
                                                   getattr(pa, metric), mode, eval_func, **kwargs)
    jbest, jperm = jfa.permutation_invariant_training(jnp.asarray(preds), jnp.asarray(target), getattr(jfa, metric),
                                                      mode, eval_func, **kwargs)
    assert perm.tolist() == np.asarray(jperm).tolist()
    _close(best, jbest)
    assert np.array_equal(pa.pit_permutate(torch.from_numpy(preds), perm).numpy(),
                          np.asarray(jfa.pit_permutate(jnp.asarray(preds), jperm)))


@pytest.mark.parametrize("norm", [False, True])
def test_srmr_matches_jax(ja, norm):
    jfa, jnp = ja
    rng = np.random.RandomState(8)
    t = np.arange(4000) / 8000
    speech = (np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 4 * t)) + 0.3 * rng.randn(2, 4000)).astype(np.float32)
    got = pa.speech_reverberation_modulation_energy_ratio(torch.from_numpy(speech), 8000, n_cochlear_filters=6, norm=norm)
    want = jfa.speech_reverberation_modulation_energy_ratio(jnp.asarray(speech), 8000, n_cochlear_filters=6, norm=norm)
    assert got.shape == (2,) and got.dtype == torch.float32
    _close(got, want, rtol=1e-6, atol=0)


def test_audio_errors_match_jax(ja):
    """Each guard of the audio entries raises JAX's error type and message: shapes, modes, SRMR's
    arguments and ``fast=True`` without ``gammatone``, PESQ and STOI without their packages."""
    jfa, jnp = ja
    a, b = np.zeros((2, 2, 8), np.float32), np.zeros((2, 2, 9), np.float32)
    one = np.zeros(8, np.float32)
    spec, bad_spec = np.zeros((2, 3, 4, 2), np.float32), np.zeros((2, 3, 4, 3), np.float32)
    calls = [
        ("signal_noise_ratio", (a, b), {}),
        ("scale_invariant_signal_distortion_ratio", (a, b), {}),
        ("source_aggregated_signal_distortion_ratio", (one, one), {}),
        ("source_aggregated_signal_distortion_ratio", (a, b), {}),
        ("complex_scale_invariant_signal_noise_ratio", (spec, bad_spec), {}),
        ("signal_distortion_ratio", (a, b), {}),
        ("permutation_invariant_training", (a, np.zeros((2, 3, 8), np.float32), "snr"), {}),
        ("permutation_invariant_training", (a, a, "snr"), {"eval_func": "mean"}),
        ("permutation_invariant_training", (a, a, "snr"), {"mode": "pair-wise"}),
        ("permutation_invariant_training", (one, one, "snr"), {}),
        ("speech_reverberation_modulation_energy_ratio", (one, 0), {}),
        ("speech_reverberation_modulation_energy_ratio", (one, 8000), {"n_cochlear_filters": 0}),
        ("speech_reverberation_modulation_energy_ratio", (one, 8000), {"low_freq": -1}),
        ("speech_reverberation_modulation_energy_ratio", (one, 8000), {"min_cf": 0}),
        ("speech_reverberation_modulation_energy_ratio", (one, 8000), {"max_cf": "x"}),
        ("speech_reverberation_modulation_energy_ratio", (one, 8000), {"norm": 1}),
        ("speech_reverberation_modulation_energy_ratio", (one, 8000), {"fast": 1}),
        ("speech_reverberation_modulation_energy_ratio", (np.ones(8000, np.float32), 8000), {"fast": True}),
        ("perceptual_evaluation_speech_quality", (one, one, 8000, "nb"), {}),
        ("short_time_objective_intelligibility", (one, one, 8000), {}),
    ]
    for name, args, kwargs in calls:
        jargs = [jfa.signal_noise_ratio if isinstance(x, str) else jnp.asarray(x) if isinstance(x, np.ndarray) else x
                 for x in args]
        pargs = [pa.signal_noise_ratio if isinstance(x, str) else torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                 for x in args]
        warns = pytest.warns(UserWarning, match="gammatonegram") if kwargs.get("fast") is True else nullcontext()
        with warns, pytest.raises(Exception) as jerr:
            getattr(jfa, name)(*jargs, **kwargs)
        warns = pytest.warns(UserWarning, match="gammatonegram") if kwargs.get("fast") is True else nullcontext()
        with warns, pytest.raises(type(jerr.value)) as perr:
            getattr(pa, name)(*pargs, **kwargs)
        assert str(perr.value) == str(jerr.value), name
