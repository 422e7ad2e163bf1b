"""``chip_smoke.py``'s path Q, the generative image metrics and the audio domain, at a small size on the CPU.

``run_path_q`` runs whole on CPU tensors, on the emulated graph tier (``dispatch.EMULATE_ON_CPU``) and on
the eager tier, with its checks against the float64 numpy side: FID within its first-order bound of
``np.cov`` and within 4u of numpy's formula on the metric's own states, the extractor routes bit-equal
to raw-feature mode, KID, IS and MiFID within their bounds, LPIPS and PPL within 1e-5 relative (PPL's
discards exactly numpy's), the audio means within their first-order bounds, the audio classes one
capture and a replay an update, both tiers bit-equal, no kernel launched. The sizes are cut: Q1 1,200
features of width 48, KID 5 subsets of 100, IS 30 classes, MiFID 600 against 300; Q2 images of 32 x 32,
PPL over 100 latents of 16; Q3 30 mixtures of 4,000 samples, SDR's filter 64, SRMR 4 utterances of 0.5 s.
The float64 numpy side is held to the port's CPU entries (which the other new files hold to the JAX
package) and ``torch.stft`` on the same data, so that its formulas are the metrics'.
"""
from __future__ import annotations

import numpy as np
import torch

import chip_smoke
from torchmetrics_tpu_torch.ops import dispatch

SMALL = dict(chip_smoke.Q_SIZES, q1_rows=1200, q1_dim=48, q1_batch=200, q1_rank=8, q1_images=3, q1_image_batches=4,
             q1_hw=40, kid_subsets=5, kid_subset_size=100, is_classes=30, is_splits=3, mifid_real=600, mifid_fake=300,
             mifid_copies=240, sqrtm_dim=16, q2_hw=32, q2_batch=4, q2_batches=3, ppl_samples=100, ppl_batch=64,
             ppl_latent=16, q3_mixtures=30, q3_samples=4000, q3_batch=10, sdr_mixtures=20, sdr_filter=64,
             srmr_utterances=4, srmr_samples=8000, srmr_batch=2, threads=4)


def test_run_path_q_whole(monkeypatch, capsys):
    """Path Q end to end on both tiers: every check passes, the tiers are bit-equal, no kernel launches."""
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    seconds = chip_smoke.run_path_q(torch.device("cpu"), "cpu", SMALL)
    out = capsys.readouterr().out
    assert seconds > 0 and "both tiers bit-equal" in out
    for name in ("FID-50k", "KID", "IS", "MiFID", "LPIPS", "PPL lerp", "PPL slerp_unit", "PIT", "SI-SDR", "SNR",
                 "SA-SDR", "C-SI-SNR", "SDR", "SRMR"):
        assert f"] {name}, graph tier" in out and f"] {name}, eager tier" in out, name
    assert "1 captures, 3 replays, eager fallbacks: none" in out  # the audio classes' graph tier
    assert "eager fallbacks: update jit_update_off" in out  # FID asked for fast_update, keeps JAX's flag


def test_float64_side_is_the_metrics_formulas():
    """The numpy side against the port's CPU entries on the same data (``tests/test_torch_generative.py`` and
    ``tests/test_torch_audio.py`` hold those to the JAX package): the two-eigh FID against
    ``_compute_fid`` in float64 (rtol 1e-12), a KID subset against ``_poly_mmd`` (float32, rtol 1e-5, its
    bound under 1e-3 of the value), SI-SDR, SNR and SA-SDR against the entries (rtol 1e-5), SDR against
    ``signal_distortion_ratio`` (rtol 2e-5), numpy's STFT against ``torch.stft`` in float64 (1e-12), and
    PPL's discards against the functional's (its index rule is held to ``jnp.quantile`` there)."""
    import torchmetrics_tpu_torch.functional.audio as pfa
    from torchmetrics_tpu_torch.image import generative as pg

    rng = np.random.RandomState(5)
    a, b = rng.randn(300, 12).astype(np.float32), (1.1 * rng.randn(300, 12) + 0.3).astype(np.float32)
    args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False))
    np.testing.assert_allclose(chip_smoke.fid_np(*args), float(pg._compute_fid(*(torch.from_numpy(x) for x in args))),
                               rtol=1e-12)
    value, bound = chip_smoke._kid_subset_np(a[:50].astype(np.float64), b[:50].astype(np.float64))
    np.testing.assert_allclose(value, float(pg._poly_mmd(torch.from_numpy(a[:50]), torch.from_numpy(b[:50]), 3, None, 1.0)),
                               rtol=1e-5)
    assert 0 < bound < 1e-3 * abs(value)
    p, t = rng.randn(3, 2, 500).astype(np.float32), rng.randn(3, 2, 500).astype(np.float32)
    tp, tt = torch.from_numpy(p), torch.from_numpy(t)
    for got, want in ((chip_smoke._si_sdr_np(p, t)[0], pfa.scale_invariant_signal_distortion_ratio(tp, tt)),
                      (chip_smoke._si_sdr_np(p, t, scale_invariant=False)[0], pfa.signal_noise_ratio(tp, tt)),
                      (chip_smoke._si_sdr_np(p, t, axes=(-2, -1))[0], pfa.source_aggregated_signal_distortion_ratio(tp, tt))):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5)
    target = np.cumsum(rng.randn(800)).astype(np.float32) * 0.05 + rng.randn(800).astype(np.float32)
    preds = (0.8 * target + 0.2 * rng.randn(800)).astype(np.float32)
    np.testing.assert_allclose(chip_smoke._sdr_np(preds, target, 32)[0],
                               float(pfa.signal_distortion_ratio(torch.from_numpy(preds), torch.from_numpy(target), filter_length=32)),
                               rtol=2e-5)
    x = rng.randn(2, 3, 1000)
    want = torch.stft(torch.from_numpy(x).reshape(-1, 1000), 128, 32, window=torch.hann_window(128, dtype=torch.float64),
                      return_complex=True).reshape(2, 3, 65, -1).numpy()
    np.testing.assert_allclose(chip_smoke._stft_np(x, 128, 32), want, rtol=0, atol=1e-12)
    dist = rng.rand(91).astype(np.float32)
    keep, *_ = chip_smoke._ppl_np(dist, 0.01, 0.7)
    assert keep.sum() == 64 and pg._lower_quantile_index(0.7, 91) == 63
