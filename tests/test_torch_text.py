"""The port's functional text entries (``functional/text/``) against the JAX package's.

The same seeded stand-in sentences (``tests/torch_text_corpus.py``) go through both packages on the
CPU: every entry under each of its options (n-gram orders, ``smooth``, weights, every SacreBLEU tokenizer
that runs here, ``lowercase``, chrF's orders and ``whitespace``, TER's four flags, EED's four weights and
both languages, ROUGE's keys and ``accumulate``, ``substitution_cost``, ``reduction``, ``ignore_index``),
and the degenerate inputs (empty strings, empty batches, zero n-gram denominators, all-ignored tokens).
Distances and counts are held equal exactly, scores within 1e-6, perplexity within 1e-5 relative; NaN
where JAX gives NaN. The row scan of ``_edit.py`` is held to a plain integer DP written here, and its
graph tier (``dispatch.EMULATE_ON_CPU``) to its eager one. The JAX package's ROUGE split is told that
``punkt`` is absent, so that it neither looks for it on the network nor downloads it. JAX is imported
inside fixtures.
"""
from __future__ import annotations

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.functional as pf
from torchmetrics_tpu_torch.functional.text import _edit, rouge
from torchmetrics_tpu_torch.ops import dispatch
from torch_text_corpus import hypotheses, sentences

TOL = 1e-6
REFS = sentences(11, 8, empty_every=5)
HYPS = hypotheses(REFS, 12)
REFS2 = sentences(13, 8)


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import torchmetrics_tpu.functional as jf
    import torchmetrics_tpu.functional.text.rouge as jrouge

    saved = jrouge._PUNKT_AVAILABLE
    jrouge._PUNKT_AVAILABLE = False  # no network probe, no download: the regex split, as the port's here
    yield SimpleNamespace(f=jf, jnp=jnp, rouge=jrouge)
    jrouge._PUNKT_AVAILABLE = saved


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


def _dp(a, b, cost=1):
    """The plain Levenshtein DP, integers."""
    d = np.arange(len(b) + 1)
    for i, x in enumerate(a, 1):
        prev, d[0] = d.copy(), i
        for j, y in enumerate(b, 1):
            d[j] = min(prev[j] + 1, d[j - 1] + 1, prev[j - 1] + (0 if x == y else cost))
    return int(d[-1])


# ------------------------------------------------------------------ the row scan
@pytest.mark.parametrize("cost", [0, 1, 2])
def test_row_scan_equals_plain_dp(cost):
    rng = np.random.RandomState(cost)
    pairs = [(list(rng.randint(0, 4, rng.randint(0, 20))), list(rng.randint(0, 4, rng.randint(0, 20))))
             for _ in range(37)]
    pairs += [([], []), ([1], []), ([], [2, 3])]
    got = _edit.edit_distance_batch([p for p, _ in pairs], [t for _, t in pairs], cost, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (len(pairs),)
    assert got.tolist() == [_dp(p, t, cost) for p, t in pairs]


def test_row_scan_graph_tier_is_the_eager_bits(monkeypatch):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    monkeypatch.setattr(_edit, "_GRAPHS", {})
    dispatch.STATS.reset()
    words = [s.split() for s in REFS]
    hyps = [s.split() for s in HYPS]
    graph = [_edit.edit_distance_batch(hyps, words, 1.0, device="cpu") for _ in range(3)]
    assert (dispatch.STATS.captures, dispatch.STATS.replays) == (1, 3)  # one capture per padded shape
    monkeypatch.setenv("TM_TPU_FAST_DISPATCH", "0")
    eager = _edit.edit_distance_batch(hyps, words, 1.0, device="cpu")
    for g in graph:
        assert torch.equal(g, eager)
    assert dispatch.STATS.captures == 1


def test_padding_is_jax_s(jax):
    from torchmetrics_tpu.functional.text import _edit as jedit

    words = [s.split() for s in REFS]
    hyps = [s.split() for s in HYPS]
    pp, pl, tt, tl = _edit.padded_ids(hyps, words)
    assert pp.shape == (8, 16) and tt.shape[0] == 8 and (pp[pl == 0] == -1).all() and (tt[:, -1] == -2).any()
    np.testing.assert_array_equal(_edit.edit_distance_batch(hyps, words, device="cpu").numpy(),
                                  jedit.edit_distance_batch(hyps, words))


# ------------------------------------------------------------------ edit distance and error rates
@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
@pytest.mark.parametrize("cost", [1, 2])
def test_edit_distance(jax, cost, reduction):
    got = pf.edit_distance(HYPS, REFS, cost, reduction, device="cpu")
    want = jax.f.edit_distance(HYPS, REFS, cost, reduction)
    assert str(got.dtype).split(".")[-1] == str(np.asarray(want).dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_edit_distance_edges(jax):
    for preds, target in (("kitten", "sitting"), ([""], ["abc"]), (["abc"], [""]), ([], [])):
        for reduction in ("mean", "none"):
            got = pf.edit_distance(preds, target, reduction=reduction, device="cpu")
            np.testing.assert_array_equal(got.numpy(), np.asarray(jax.f.edit_distance(preds, target, reduction=reduction)))
    for bad in ((["a"], ["b", "c"]), ([1], ["a"])):
        with pytest.raises(ValueError):
            jax.f.edit_distance(*bad)
        with pytest.raises(ValueError):
            pf.edit_distance(*bad, device="cpu")


ERROR_RATES = ["word_error_rate", "char_error_rate", "match_error_rate", "word_information_lost",
               "word_information_preserved"]


@pytest.mark.parametrize("name", ERROR_RATES)
def test_error_rates(jax, name):
    for preds, target in ((HYPS, REFS2), ("the cat sat", "the cat sat down"), (["a b", ""], ["a c", "d e f"])):
        _close(getattr(pf, name)(preds, target, device="cpu"), getattr(jax.f, name)(preds, target))


# ------------------------------------------------------------------ BLEU and SacreBLEU
BLEU_CASES = [dict(n_gram=n, smooth=s) for n in (1, 2, 3, 4) for s in (False, True)]
BLEU_CASES += [dict(n_gram=2, weights=[0.9, 0.1]), dict(n_gram=3, weights=[0.0, 0.5, 0.5], smooth=True)]


@pytest.mark.parametrize("kwargs", BLEU_CASES, ids=str)
def test_bleu(jax, kwargs):
    multi = [[r, r2] for r, r2 in zip(REFS, REFS2)]
    for target in (multi, [[r] for r in REFS]):
        _close(pf.bleu_score(HYPS, target, device="cpu", **kwargs), jax.f.bleu_score(HYPS, target, **kwargs))


def test_bleu_degenerate_counts(jax):
    """Empty and one-word hypotheses leave zero n-gram denominators: the 1e-38 guards' sites."""
    for preds, target in ((["", ""], [["a b"], ["c"]]), (["a"], [["a"]]), ([], []), (["x y", "z"], [["x y"], ["z"]])):
        for smooth in (False, True):
            got = pf.bleu_score(preds, target, smooth=smooth, device="cpu")
            _close(got, jax.f.bleu_score(preds, target, smooth=smooth))
    with pytest.raises(ValueError, match="different weights"):
        pf.bleu_score(HYPS, REFS, n_gram=2, weights=[1.0], device="cpu")
    with pytest.raises(ValueError, match="different size"):
        pf.bleu_score(HYPS, REFS[:2], device="cpu")


def test_bleu_counts_where_no_reference_has_an_order(jax):
    """No reference of the batch holds a bigram: the JAX package's vectorised count raises IndexError in
    ``np.maximum.reduceat``; the port counts as JAX's own loop twin ``_bleu_score_update`` (the reference's
    ``Counter`` passes) does."""
    from torchmetrics_tpu.functional.text import bleu as jbleu
    from torchmetrics_tpu_torch.functional.text import bleu as pbleu

    preds, target = ["x y z", "a b"], [["x"], [""]]
    with pytest.raises(IndexError):
        jax.f.bleu_score(preds, target)
    for n_gram in (1, 2, 4):
        want_num, want_den, got_num, got_den = (np.zeros(n_gram) for _ in range(4))
        want = jbleu._bleu_score_update(preds, target, want_num, want_den, 0.0, 0.0, n_gram)
        got = pbleu._bleu_score_update_batched(preds, target, got_num, got_den, 0.0, 0.0, n_gram)
        assert got == want and got_num.tolist() == want_num.tolist() and got_den.tolist() == want_den.tolist()
    assert float(pf.bleu_score(preds, target, device="cpu")) == 0.0


@pytest.mark.parametrize("lowercase", [False, True])
@pytest.mark.parametrize("tokenize", ["none", "13a", "zh", "intl", "char"])
def test_sacre_bleu(jax, tokenize, lowercase):
    pytest.importorskip("regex") if tokenize == "intl" else None
    target = [[r, r2] for r, r2 in zip(REFS, REFS2)]
    _close(pf.sacre_bleu_score(HYPS, target, tokenize=tokenize, lowercase=lowercase, device="cpu"),
           jax.f.sacre_bleu_score(HYPS, target, tokenize=tokenize, lowercase=lowercase))


def test_sacre_bleu_tokenizers_that_raise(jax):
    for tokenize in ("ja-mecab", "flores200", "nope"):
        with pytest.raises(ValueError) as theirs:
            jax.f.sacre_bleu_score(HYPS, [[r] for r in REFS], tokenize=tokenize)
        with pytest.raises(ValueError) as ours:
            pf.sacre_bleu_score(HYPS, [[r] for r in REFS], tokenize=tokenize, device="cpu")
        assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------------------ chrF
CHRF_CASES = [dict(), dict(n_word_order=0), dict(n_char_order=3, n_word_order=1, beta=1.0),
              dict(lowercase=True, whitespace=True), dict(n_char_order=1, n_word_order=3, beta=3.0)]


@pytest.mark.parametrize("kwargs", CHRF_CASES, ids=str)
def test_chrf(jax, kwargs):
    target = [[r, r2] for r, r2 in zip(REFS, REFS2)]
    got, got_s = pf.chrf_score(HYPS, target, return_sentence_level_score=True, device="cpu", **kwargs)
    want, want_s = jax.f.chrf_score(HYPS, target, return_sentence_level_score=True, **kwargs)
    _close(got, want)
    _close(got_s, want_s)
    _close(pf.chrf_score(HYPS[0], REFS[:1], device="cpu", **kwargs), jax.f.chrf_score(HYPS[0], REFS[:1], **kwargs))


def test_chrf_degenerate_and_errors(jax):
    for preds, target in (([""], [[""]]), (["abc"], [[]]), ([], []), (["a"], [["b"]])):
        _close(pf.chrf_score(preds, target, device="cpu"), jax.f.chrf_score(preds, target))
    for bad in (dict(n_char_order=0), dict(n_word_order=-1), dict(beta=-1.0)):
        with pytest.raises(ValueError) as theirs:
            jax.f.chrf_score(HYPS, REFS, **bad)
        with pytest.raises(ValueError) as ours:
            pf.chrf_score(HYPS, REFS, device="cpu", **bad)
        assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------------------ TER and EED
TER_FLAGS = [dict(), dict(normalize=True), dict(no_punctuation=True), dict(lowercase=False),
             dict(normalize=True, asian_support=True, no_punctuation=True)]


@pytest.mark.parametrize("kwargs", TER_FLAGS, ids=str)
def test_ter(jax, kwargs):
    target = [[r, r2] for r, r2 in zip(REFS, REFS2)]
    got, got_s = pf.translation_edit_rate(HYPS, target, return_sentence_level_score=True, device="cpu", **kwargs)
    want, want_s = jax.f.translation_edit_rate(HYPS, target, return_sentence_level_score=True, **kwargs)
    _close(got, want)
    assert len(got_s) == len(want_s)
    _close(torch.cat(got_s), np.concatenate([np.asarray(w) for w in want_s]))


def test_ter_edges(jax):
    for preds, target in (("the cat", ["a cat", "the dog"]), ([""], [[""]]), (["a b"], [[""]]), ([], [])):
        _close(pf.translation_edit_rate(preds, target, device="cpu"), jax.f.translation_edit_rate(preds, target))
    with pytest.raises(ValueError, match="boolean"):
        pf.translation_edit_rate(HYPS, REFS, normalize=1, device="cpu")


EED_CASES = [dict(), dict(alpha=1.0, rho=0.5, deletion=0.4, insertion=0.5), dict(language="ja"),
             dict(deletion=0.0, insertion=2.0)]


@pytest.mark.parametrize("kwargs", EED_CASES, ids=str)
def test_eed(jax, kwargs):
    target = [[r, r2] for r, r2 in zip(REFS, REFS2)]
    got, got_s = pf.extended_edit_distance(HYPS, target, return_sentence_level_score=True, device="cpu", **kwargs)
    want, want_s = jax.f.extended_edit_distance(HYPS, target, return_sentence_level_score=True, **kwargs)
    _close(got, want)
    _close(torch.cat(got_s), np.concatenate([np.asarray(w) for w in want_s]))


def test_eed_edges(jax):
    for preds, target in ((["abc"], [""]), ([""], ["abc"]), ([], [])):
        _close(pf.extended_edit_distance(preds, target, device="cpu"), jax.f.extended_edit_distance(preds, target))
    for bad in (dict(alpha=-1.0), dict(rho=1), dict(language="de")):
        with pytest.raises(ValueError) as theirs:
            jax.f.extended_edit_distance(HYPS, REFS, **bad)
        with pytest.raises(ValueError) as ours:
            pf.extended_edit_distance(HYPS, REFS, device="cpu", **bad)
        assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------------------ ROUGE and SQuAD
ROUGE_CASES = [dict(), dict(accumulate="avg"), dict(rouge_keys=("rouge3", "rougeL")), dict(rouge_keys="rougeLsum"),
               dict(normalizer=str.upper, tokenizer=lambda s: s.split(" ")), dict(rouge_keys=("rouge9", "rouge1"))]


@pytest.mark.parametrize("kwargs", ROUGE_CASES, ids=range(len(ROUGE_CASES)))
def test_rouge(jax, kwargs):
    summaries = [f"{a}. {b}! {c}?" for a, b, c in zip(HYPS, REFS2, HYPS[::-1])]
    refs = [[f"{a}. {b}", f"{c}. {a}"] for a, b, c in zip(REFS, REFS2, HYPS)]
    for preds, target in ((summaries, refs), (summaries[0], refs[0]), (summaries[:3], [r[0] for r in refs[:3]]),
                          ([""], [[""]])):
        got = pf.rouge_score(preds, target, device="cpu", **kwargs)
        want = jax.f.rouge_score(preds, target, **kwargs)
        assert list(got) == list(want)
        for key in want:
            _close(got[key], want[key])


def test_rouge_split_without_nltk(jax, monkeypatch):
    """Without nltk the port splits by the regex where JAX raises ImportError; the stemmer raises in both."""
    monkeypatch.setitem(sys.modules, "nltk", None)
    monkeypatch.setattr(rouge, "_PUNKT_AVAILABLE", None)
    text = "One sentence here. And another one! A third?"
    assert rouge._split_sentence(text) == ["One sentence here.", "And another one!", "A third?"]
    monkeypatch.setattr(jax.rouge, "_PUNKT_AVAILABLE", None)
    with pytest.raises(ImportError):
        jax.rouge._split_sentence(text)
    with pytest.raises(ImportError):
        pf.rouge_score("a b", "a c", use_stemmer=True, device="cpu")


def test_rouge_errors(jax):
    for bad in (dict(rouge_keys="rouge10"), dict(accumulate="max")):
        with pytest.raises(ValueError) as theirs:
            jax.f.rouge_score("a", "b", **bad)
        with pytest.raises(ValueError) as ours:
            pf.rouge_score("a", "b", device="cpu", **bad)
        assert str(ours.value) == str(theirs.value)


def _squad_data(seed: int):
    rng = np.random.RandomState(seed)
    answers = sentences(seed, 30, max_words=4)
    preds = [{"prediction_text": a if rng.rand() < 0.4 else str(rng.choice(answers)), "id": str(i)}
             for i, a in enumerate(answers) if i % 7]
    target = [{"answers": {"answer_start": [0], "text": [a, *rng.choice(answers, rng.randint(0, 3))]}, "id": str(i)}
              for i, a in enumerate(answers)]
    return preds, target


def test_squad(jax):
    preds, target = _squad_data(3)
    got, want = pf.squad(preds, target, device="cpu"), jax.f.squad(preds, target)
    assert list(got) == list(want)
    for key in want:
        _close(got[key], want[key])
    _close(pf.squad(preds[0], target[0], device="cpu")["f1"], jax.f.squad(preds[0], target[0])["f1"])
    with pytest.raises(KeyError):
        pf.squad([{"id": "1"}], target, device="cpu")


# ------------------------------------------------------------------ perplexity
@pytest.mark.parametrize("ignore_index", [None, -100, 3])
def test_perplexity(jax, ignore_index):
    rng = np.random.RandomState(5)
    logits = (rng.randn(3, 17, 50) * 4).astype(np.float32)
    target = rng.randint(0, 50, (3, 17))
    if ignore_index is not None:
        target[:, :5] = ignore_index
    got = pf.perplexity(torch.from_numpy(logits), torch.from_numpy(target), ignore_index)
    _close(got, jax.f.perplexity(logits, target, ignore_index), 1e-5)
    half = pf.perplexity(torch.from_numpy(logits).half(), torch.from_numpy(target), ignore_index)
    _close(half, jax.f.perplexity(logits.astype(np.float16), target, ignore_index), 1e-5)


def test_perplexity_all_ignored_and_errors(jax):
    logits = np.zeros((1, 2, 3), np.float32)
    target = np.full((1, 2), -1)
    _close(pf.perplexity(torch.from_numpy(logits), torch.from_numpy(target), -1), jax.f.perplexity(logits, target, -1))
    for bad_p, bad_t, err in ((np.zeros((2, 3)), np.zeros((2, 3), np.int64), ValueError),
                              (np.zeros((1, 2, 3)), np.zeros((1, 2, 3), np.int64), ValueError),
                              (np.zeros((1, 2, 3)), np.zeros((1, 3), np.int64), ValueError),
                              (np.zeros((1, 2, 3), np.int64), np.zeros((1, 2), np.int64), TypeError),
                              (np.zeros((1, 2, 3), np.float32), np.zeros((1, 2), np.float32), TypeError)):
        with pytest.raises(err):
            jax.f.perplexity(bad_p, bad_t)
        with pytest.raises(err):
            pf.perplexity(torch.from_numpy(bad_p), torch.from_numpy(bad_t))
