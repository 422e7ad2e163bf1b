"""``chip_smoke.py``'s path S at a small size on the CPU (stand-in encoders a few units wide, S1-S4 on the emulated
graph tier and the eager tier, bit-equal, each value within its bound of float64), and path S's float64 oracles
(``bert_score_np``, ``infolm_measure_np``, ``clip_iqa_np``) against the JAX package's functionals."""
from __future__ import annotations

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from torchmetrics_tpu_torch.ops import dispatch  # noqa: E402

S_SMALL = dict(chip_smoke.S_SIZES, s1_pairs=24, s1_vocab=200, batch=8, s1_layers_pairs=8, s1_chunk=16, s2_pairs=8,
               s3_images=12, s4_images=10, num_layers=1, s2_max_length=8,
               roberta={"vocab": 300, "layers": 2, "dim": 16, "heads": 2, "ffn": 32, "positions": 130},
               bert={"vocab": 200, "layers": 2, "dim": 16, "heads": 2, "ffn": 32, "positions": 32},
               vit={"image": 28, "patch": 14, "layers": 1, "dim": 16, "heads": 2, "ffn": 32},
               clip_text={"vocab": 100, "context": 16, "layers": 1, "dim": 16, "heads": 2, "ffn": 32}, clip_proj=8)


def test_run_path_s_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    seconds = chip_smoke.run_path_s(torch.device("cpu"), "cpu", S_SMALL)
    out = capsys.readouterr().out
    assert seconds > 0 and "both tiers bit-equal" in out and "reduced: S2 over the first 8" in out
    assert "path S2 [cpu] fisher_rao_distance, graph tier" in out


def test_path_s_oracles_against_jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu.functional.multimodal.clip as jclip

    jbert = importlib.import_module("torchmetrics_tpu.functional.text.bert")
    jinfolm = importlib.import_module("torchmetrics_tpu.functional.text.infolm")
    rng = np.random.RandomState(0)
    p, t = rng.randn(5, 7, 6).astype(np.float32), rng.randn(5, 6, 6).astype(np.float32)
    pm, tm = (rng.rand(5, 7) > 0.3).astype(np.int64), (rng.rand(5, 6) > 0.3).astype(np.int64)
    pm[2] = 0  # an all-special row
    t7, tm7 = np.pad(t, ((0, 0), (0, 1), (0, 0))), np.pad(tm, ((0, 0), (0, 1)))
    w = rng.rand(5, 7).astype(np.float32)
    want = jbert._bert_score_from_embeddings(p, pm, t7, tm7, w, None)
    got = chip_smoke.bert_score_np(p, pm, t7, tm7, w, None)
    for key in ("precision", "recall", "f1"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-6)
    bags = rng.dirichlet(np.ones(30), (2, 4))
    for measure, a, b in chip_smoke.S_MEASURES:
        value, scale = chip_smoke.infolm_measure_np(measure, bags[0], bags[1], a, b)
        ref = jinfolm._information_measure(bags[0].astype(np.float32), bags[1].astype(np.float32), measure, a, b)
        np.testing.assert_allclose(value, np.asarray(ref), rtol=1e-4, atol=1e-6 * scale.max(), err_msg=measure)
    img, anchors = rng.randn(4, 5).astype(np.float32), rng.randn(6, 5).astype(np.float32)
    ref = jclip._clip_iqa_compute(jclip._normalize(img), jclip._normalize(anchors), ["a", "b", "c"], format_as_dict=False)
    np.testing.assert_allclose(chip_smoke.clip_iqa_np(img, anchors), np.asarray(ref), atol=1e-5)
