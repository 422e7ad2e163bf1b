"""``chip_smoke.py``'s path R at a small size on the CPU: the stand-in corpora, the oracles (run in this
process), R1-R4 on the emulated graph tier (``dispatch.EMULATE_ON_CPU``) and on the eager tier, the tiers
bit-equal over R1's and R3's prefixes and over R2 and R4, every R2 distance equal to the integer DP, BLEU and
chrF within 1e-6 of the ``Counter`` passes, TER, EED, SQuAD and ROUGE within their float32 bounds of the
functionals, Perplexity within its bound of the float64 side; and the oracles against the JAX package."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from torchmetrics_tpu_torch.functional.text import _edit  # noqa: E402
from torchmetrics_tpu_torch.ops import dispatch  # noqa: E402

R_SMALL = dict(chip_smoke.R_SIZES, r1_segments=40, r1_vocab=300, r1_cjk=12, r2_utterances=40, r2_vocab=200,
               r3_questions=50, r3_pairs=30, r3_vocab=300, r4_vocab=97, r4_context=16, r4_windows=6, r4_batch=2,
               r4_stride=8, batch=8, eager_prefix=16, workers=0)


def test_run_path_r_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    monkeypatch.setattr(_edit, "_GRAPHS", {})
    seconds = chip_smoke.run_path_r(torch.device("cpu"), "cpu", R_SMALL)
    out = capsys.readouterr().out
    assert seconds > 0 and "both tiers bit-equal" in out and "reduced: R1 and R3" in out
    assert "path R4 [cpu] stride 512, ignore_index=-100, graph tier" in out


def test_path_r_oracles_against_jax():
    """The plain ``Counter`` BLEU and chrF and the integer DP of ``chip_smoke.py`` against the JAX package's
    functionals on path R's stand-in data."""
    pytest.importorskip("jax")
    import torchmetrics_tpu.functional as jf

    d1 = chip_smoke.path_r1_data(R_SMALL)
    target = [[r] for r in d1["refs"]]
    np.testing.assert_allclose(chip_smoke.bleu_np(d1["hyps"], d1["refs"], "none"), float(jf.bleu_score(d1["hyps"], target)),
                               rtol=1e-6)
    for kind in ("13a", "char", "zh"):
        hyps, refs = (d1["hyps_cjk"], d1["refs_cjk"]) if kind != "13a" else (d1["hyps"], d1["refs"])
        want = float(jf.sacre_bleu_score(hyps, [[r] for r in refs], tokenize=kind))
        np.testing.assert_allclose(chip_smoke.bleu_np(hyps, refs, kind), want, rtol=1e-6, atol=1e-7)
    for n_word in (0, 2):
        score, sentences = chip_smoke.chrf_np(d1["hyps"], d1["refs"], n_word)
        want, want_s = jf.chrf_score(d1["hyps"], target, n_word_order=n_word, return_sentence_level_score=True)
        np.testing.assert_allclose(score, float(want), rtol=1e-6)
        np.testing.assert_allclose(sentences, np.asarray(want_s), atol=1e-6)
    d2 = chip_smoke.path_r2_data(R_SMALL)
    pairs = list(zip(d2["hyps"], d2["refs"]))
    from torchmetrics_tpu.functional.text._edit import edit_distance_batch

    for cost in (1, 2):
        want = edit_distance_batch([list(h) for h, _ in pairs], [list(r) for _, r in pairs], cost)
        assert [chip_smoke.levenshtein_np(h, r, cost) for h, r in pairs] == want.astype(int).tolist()
    assert all(len(w) == len(r.split()) for w, r in zip(d2["refs_words"], d2["refs"]))
