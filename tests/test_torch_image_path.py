"""``chip_smoke.py``'s path P, pairwise distances and image quality, at a small size on the CPU.

The functions that drive path P on the card run here on CPU tensors, on the emulated graph tier
(``dispatch.EMULATE_ON_CPU``) and on the eager tier, with their checks against the float64 numpy
side: SSIM, MS-SSIM, UQI and VIF within 1e-4 absolute, PSNR and PSNR-B within 1e-4 relative, the rest
within 1e-5 relative or their derived float32 bounds; image gradients equal to numpy's; both tiers
bit-equal. The sizes are cut: P1 6 images of 3 x 48 x 64 in batches of 3 and MS-SSIM with three
betas (five need 176 rows at an 11-tap window), P2 4 scenes of 6 x 32 x 40, P3 96 x 24 rows.
``run_path_p`` runs whole, the TF32 flags included (on the CPU they reach oneDNN only). The float64
numpy side is also held to the JAX package's values on the same data, so that its formulas are the
metrics' (JAX within its float32 rounding of them).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import pytest
import torch

import chip_smoke
from torchmetrics_tpu_torch.ops import dispatch

SMALL = dict(chip_smoke.P_SIZES, p1_images=6, p1_batch=3, p1_hw=(48, 64), p2_scenes=4, p2_batch=2, p2_bands=6,
             p2_hw=(32, 40), p3_rows=96, p3_l1_rows=64, p3_dim=24, p3_sample=16, ms_betas=(0.3, 0.3, 0.4), threads=4)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    d1, d2, d3 = chip_smoke.path_p1_data(SMALL), chip_smoke.path_p2_data(SMALL), chip_smoke.path_p3_data(SMALL)
    return {"P1": (d1, chip_smoke.path_p1_refs(d1, SMALL)), "P2": (d2, chip_smoke.path_p2_refs(d2, SMALL)),
            "P3": (d3, chip_smoke.path_p3_refs(d3, SMALL))}


def _on_tier(tier: str, monkeypatch) -> None:
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", tier == "graph")
    if tier == "eager":
        monkeypatch.setenv(dispatch.ENV_FAST_DISPATCH, "0")
    else:
        monkeypatch.delenv(dispatch.ENV_FAST_DISPATCH, raising=False)


@pytest.mark.parametrize("part", ["P1", "P2", "P3"])
def test_part_on_both_tiers(monkeypatch, data, part):
    fn = {"P1": chip_smoke.run_path_p1, "P2": chip_smoke.run_path_p2, "P3": chip_smoke.run_path_p3}[part]
    results = {}
    for tier in ("graph", "eager"):
        _on_tier(tier, monkeypatch)
        dispatch.STATS.reset()
        results[tier], lines, errors = fn(CPU, tier, *data[part], SMALL)
        assert sorted(lines) == sorted(errors) + (["image_gradients"] if part == "P1" else [])
        assert all(err <= allowed for err, allowed, _ in errors.values())
        if tier == "graph" and part != "P3":
            list_state = {"PSNR dim=(1,2,3)", "ERGAS", "RASE", "D-lambda"}
            assert dispatch.STATS.captures == len(set(errors) - list_state)  # one graph per scalar-state class
            assert {k[1:] for k in dispatch.STATS.fallbacks} == {("update", "list_state")}
    assert results["graph"] == results["eager"]


def test_whole_path_with_the_tf32_flags(monkeypatch, capsys):
    """``run_path_p`` end to end: three runs bit-equal, no kernel launched, the caller's flags as set."""
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    seconds = chip_smoke.run_path_p(CPU, "cpu", SMALL)
    assert seconds > 0 and (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before
    out = capsys.readouterr().out
    assert "both tiers and the TF32 run bit-equal" in out and "caller's TF32 flags" in out


def test_a_wrong_value_fails_the_check(data):
    d1, refs = data["P1"]
    with pytest.raises(AssertionError, match="float64 gives"):
        chip_smoke.check_p("PSNR", refs["psnr"] * (1 + 2e-4), refs["psnr"], "psnr")
    with pytest.raises(AssertionError, match="float64 gives"):
        chip_smoke.check_p("SSIM", refs["ssim"] + 2e-4, refs["ssim"], "window")
    chip_smoke.check_p("D-lambda", 1.0 + 5e-6, 1.0, "sum")


def test_numpy_side_against_the_jax_package(data):
    """The float64 numpy side of P1-P3 against the JAX package's values on the same float32 data (JAX's
    rounding of the same formulas: the windowed means within 1e-4, the rest within 1e-4 relative)."""
    pytest.importorskip("jax")
    import jax

    import torchmetrics_tpu.functional as jf
    import torchmetrics_tpu.image as ji

    def jit(name, *args, **kwargs):
        return np.asarray(jax.jit(partial(getattr(jf, name), **kwargs))(*args))

    (d1, r1), (d2, r2), (d3, r3) = data["P1"], data["P2"], data["P3"]
    p, t = d1["preds"], d1["target"]
    b = SMALL["p1_batch"]
    np.testing.assert_allclose(jit("structural_similarity_index_measure", p, t, data_range=1.0), r1["ssim"], atol=1e-4)
    np.testing.assert_allclose(jit("universal_image_quality_index", p, t), r1["uqi"], atol=1e-4)
    np.testing.assert_allclose(jit("visual_information_fidelity", p, t), r1["vif"], atol=1e-4)
    np.testing.assert_allclose(jit("total_variation", p), r1["tv"], rtol=1e-5)
    np.testing.assert_allclose(jit("peak_signal_noise_ratio", p, t, data_range=1.0, dim=(1, 2, 3), reduction="none"),
                               r1["psnr_dim"], rtol=1e-4)
    ms = [jit("multiscale_structural_similarity_index_measure", p[i:i + b], t[i:i + b], betas=SMALL["ms_betas"],
              reduction="none") for i in range(0, len(p), b)]
    np.testing.assert_allclose(np.concatenate(ms).mean(), r1["ms_ssim"], atol=1e-4)
    for name, key in (("PeakSignalNoiseRatio", "psnr"), ("RootMeanSquaredErrorUsingSlidingWindow", "rmse_sw")):
        m = getattr(ji, name)()
        for i in range(0, len(p), b):
            m.update(p[i:i + b], t[i:i + b])
        np.testing.assert_allclose(np.asarray(m.compute()), r1[key], rtol=1e-4)
    m = ji.PeakSignalNoiseRatioWithBlockedEffect()
    for i in range(0, len(p), b):
        m.update(d1["luma_preds"][i:i + b], d1["luma_target"][i:i + b])
    np.testing.assert_allclose(np.asarray(m.compute()), r1["psnrb"], rtol=1e-4)
    p2, t2 = d2["preds"], d2["target"]
    np.testing.assert_allclose(jit("spectral_angle_mapper", p2, t2), r2["sam"], rtol=1e-4)
    np.testing.assert_allclose(jit("error_relative_global_dimensionless_synthesis", p2, t2), r2["ergas"], rtol=1e-4)
    np.testing.assert_allclose(jit("relative_average_spectral_error", p2, t2), r2["rase"], rtol=1e-4)
    np.testing.assert_allclose(jit("spectral_distortion_index", p2, t2), r2["d_lambda"], rtol=1e-4)
    x, y, rows = d3["x"], d3["y"], d3["rows"]
    m = SMALL["p3_l1_rows"]
    for key, value in (("cosine vs y", jit("pairwise_cosine_similarity", x, y)),
                       ("euclidean alone", jit("pairwise_euclidean_distance", x)),
                       ("linear vs y", jit("pairwise_linear_similarity", x, y)),
                       ("manhattan", jit("pairwise_manhattan_distance", x[:m], y[:m])),
                       ("minkowski p=3", jit("pairwise_minkowski_distance", x[:m], y[:m], exponent=3))):
        np.testing.assert_allclose(value[rows], r3[key][0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(jit("pairwise_euclidean_distance", x, y, reduction="mean"), r3["euclidean mean"][0], rtol=1e-5)
