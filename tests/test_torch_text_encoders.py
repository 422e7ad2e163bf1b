"""The port's encoder-backed text metrics (``functional/text/{bert,infolm}.py``, ``BERTScore``, ``InfoLM``)
against the JAX package's.

The model is the caller's in both packages, so both get the same tiny in-process callables: a word-hash
encoder returning fixed numpy embeddings with ``<s>``/``</s>`` positions masked as special (and a
layer-stacked twin for ``all_layers``), a tokenizer padding to its own width (so that the IDF grid is fitted
to the embedding grid), a masked LM returning fixed numpy distributions, and for the reference's
``own_model``/``user_tokenizer``/``user_forward_fn`` hooks a tiny ``torch.nn`` model that both packages
run. Scores within 1e-6, InfoLM within 1e-5 relative; every error and its message as JAX's. Nothing
imports ``transformers`` or reaches the network: the HuggingFace defaults are tested only for JAX's error
with no checkpoint, with the packages' probes switched off. One ``cuda`` test runs BERTScore at a mid
width on the card:

    python -m pytest --noconftest tests/test_torch_text_encoders.py -m cuda
"""
from __future__ import annotations

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.functional.text as pft
import torchmetrics_tpu_torch.text as pt
from torchmetrics_tpu_torch.functional.text.bert import _bert_score_from_embeddings
from torch_text_corpus import hypotheses, sentences

TOL = 1e-6
D = 8
VOCAB = 40


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import importlib

    import torchmetrics_tpu.text as jt

    # the package's ``infolm`` attribute is the function, which hides the module of that name
    jinfolm = importlib.import_module("torchmetrics_tpu.functional.text.infolm")
    return SimpleNamespace(bert=importlib.import_module("torchmetrics_tpu.functional.text.bert"), infolm=jinfolm,
                           text=jt)


def _word_id(word: str) -> int:
    return 3 + sum(ord(c) * (i + 1) for i, c in enumerate(word)) % (VOCAB - 3)


def _ids(sentences_: list, width_extra: int):
    """(ids, mask) with ``<s>`` = 0, ``</s>`` = 1, pad = 2; the mask is 1 on the words only. The width is the
    longest row's rounded up to a multiple of 6 (few shapes for JAX to compile; preds and target still pad
    apart), plus ``width_extra``."""
    rows = [[0] + [_word_id(w) for w in s.split()] + [1] for s in sentences_]
    width = -(-max([len(r) for r in rows] + [2]) // 6) * 6 + width_extra
    ids = np.full((len(rows), width), 2, np.int64)
    mask = np.zeros((len(rows), width), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, 1:len(r) - 1] = 1
    return ids, mask


_TABLE = np.random.RandomState(3).randn(4, VOCAB, D).astype(np.float32)


def encoder(sentences_):
    ids, mask = _ids(sentences_, 0)
    return _TABLE[0][ids], mask


def stacked_encoder(sentences_):
    ids, mask = _ids(sentences_, 0)
    return np.stack([_TABLE[k][ids] for k in range(3)], axis=1), mask  # (N, 3, L, D)


stacked_encoder.layer_stacked = True


def tokenize(sentences_):
    return _ids(sentences_, 2)  # pads wider than the encoder: the idf grid is cut to fit


_LOGITS = np.random.RandomState(5).randn(VOCAB, 30).astype(np.float32)


def masked_lm(sentences_):
    ids, mask = _ids(sentences_, 1)
    logits = _LOGITS[ids] / 0.25
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    return (probs / probs.sum(-1, keepdims=True)).astype(np.float32), mask


class TinyTok:
    """An HF-style tokenizer: ``[CLS] words [SEP]`` framing, padding to the batch's longest."""

    def __call__(self, sentences_, **kw):
        ids, mask = _ids(sentences_, 0)
        attn = (ids != 2).astype(np.int64)
        return {"input_ids": torch.as_tensor(ids), "attention_mask": torch.as_tensor(attn)}


class TinyModel(torch.nn.Module):
    def __init__(self) -> None:
        super().__init__()
        self.emb = torch.nn.Embedding(VOCAB, D)
        self.lin = torch.nn.Linear(D, D)
        with torch.no_grad():
            gen = torch.Generator().manual_seed(0)
            self.emb.weight.copy_(torch.randn(VOCAB, D, generator=gen))
            self.lin.weight.copy_(torch.randn(D, D, generator=gen))

    def forward(self, input_ids, attention_mask, output_hidden_states=False):
        h0 = self.emb(input_ids)
        h1 = torch.tanh(self.lin(h0)) * attention_mask[..., None]
        return SimpleNamespace(hidden_states=[h0, h1, h1 * 0.5 + h0])


def forward_fn(model, batch):
    return model.emb(batch["input_ids"]) * 2.0


def _close(got, want, tol=TOL, rel=False):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key], tol, rel)
        return
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w, tol, rel)
        return
    if isinstance(want, str):
        assert got == want
        return
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=tol, atol=0 if rel else tol)


def _pairs(seed: int, n: int):
    refs = sentences(seed, n, max_words=9, empty_every=5)
    return hypotheses(refs, seed + 1), refs


def _baseline(tmp_path, sep: str, rows: int) -> str:
    path = tmp_path / f"baseline{rows}.{'csv' if sep == ',' else 'tsv'}"
    lines = [sep.join(["LAYER", "P", "R", "F"])]
    lines += [sep.join([str(i), f"{0.1 + 0.05 * i:.3f}", f"{0.12 + 0.04 * i:.3f}", f"{0.11 + 0.03 * i:.3f}"])
              for i in range(rows)]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


#: (case, keywords for both packages); "baseline" marks a baseline file made in ``tmp_path``
BERT_CASES = [
    ("plain", {"encoder": encoder}),
    ("idf", {"encoder": encoder, "tokenize": tokenize, "idf": True}),
    ("csv baseline, num_layers=2", {"encoder": encoder, "num_layers": 2, "rescale_with_baseline": True,
                                    "baseline": ","}),
    ("tsv baseline, last row", {"encoder": encoder, "rescale_with_baseline": True, "baseline": "\t"}),
    ("no baseline file", {"encoder": encoder, "rescale_with_baseline": True}),
    ("return_hash, idf", {"encoder": encoder, "tokenize": tokenize, "idf": True, "return_hash": True,
                          "num_layers": 7}),
    ("all_layers, csv baseline", {"encoder": stacked_encoder, "all_layers": True, "rescale_with_baseline": True,
                                  "baseline": ","}),
    ("all_layers, idf", {"encoder": stacked_encoder, "all_layers": True, "tokenize": tokenize, "idf": True}),
    ("own_model", {"own_model": "model", "user_tokenizer": "tok", "num_layers": 1}),
    ("user_forward_fn", {"own_model": "model", "user_tokenizer": "tok", "user_forward_fn": forward_fn}),
    ("own_model all_layers, baseline", {"own_model": "model", "user_tokenizer": "tok", "all_layers": True,
                                        "rescale_with_baseline": True, "baseline": ","}),
    ("inert knobs", {"encoder": encoder, "verbose": True, "batch_size": 3, "num_threads": 2, "lang": "de"}),
]


def _bert_kwargs(kwargs: dict, tmp_path) -> dict:
    out = dict(kwargs)
    sep = out.pop("baseline", None)
    if sep is not None:
        out["baseline_path"] = _baseline(tmp_path, sep, 4)
    if out.get("own_model") == "model":
        out["own_model"] = TinyModel()
    if out.get("user_tokenizer") == "tok":
        out["user_tokenizer"] = TinyTok()
    return out


@pytest.mark.parametrize("case, kwargs", BERT_CASES, ids=[c[0] for c in BERT_CASES])
def test_bert_score_matches_jax(jax, tmp_path, case, kwargs):
    """Unequal lengths, empty strings (all-special rows), several batch sizes."""
    kw = _bert_kwargs(kwargs, tmp_path)
    for seed, n in ((len(case), 7), (len(case) + 1, 1)):
        preds, target = _pairs(seed, n)
        with pytest.warns(UserWarning, match="Baseline") if case == "no baseline file" else _nothing():
            want = jax.bert.bert_score(preds, target, **kw)
            got = pft.bert_score(preds, target, device="cpu", **kw)
        _close(got, want)


def test_bert_score_empty_batch_and_all_special_rows(jax):
    want = jax.bert.bert_score([], [], encoder=encoder)
    got = pft.bert_score([], [], encoder=encoder, device="cpu")
    _close(got, want)
    want = jax.bert.bert_score(["", "a b"], ["", ""], encoder=encoder, tokenize=tokenize, idf=True)
    got = pft.bert_score(["", "a b"], ["", ""], encoder=encoder, tokenize=tokenize, idf=True, device="cpu")
    _close(got, want)
    assert got["f1"].tolist() == [0.0, 0.0]


def test_matching_layers_batch_into_one_product():
    """The layer axis folded into the product's batch gives each layer's own scores."""
    rng = np.random.RandomState(0)
    emb_p, emb_t = (torch.from_numpy(rng.randn(3, 4, 6, 5).astype(np.float32)) for _ in range(2))
    mask_p = torch.from_numpy((rng.rand(4, 6) > 0.3).astype(np.int64))
    mask_t = torch.from_numpy((rng.rand(4, 6) > 0.3).astype(np.int64))
    weights = torch.from_numpy(rng.rand(4, 6).astype(np.float32))
    stacked = _bert_score_from_embeddings(emb_p, mask_p, emb_t, mask_t, weights, None)
    for layer in range(3):
        one = _bert_score_from_embeddings(emb_p[layer], mask_p, emb_t[layer], mask_t, weights, None)
        for key in one:
            torch.testing.assert_close(stacked[key][layer], one[key], rtol=0, atol=1e-7)


def _hf_off(monkeypatch, jax):
    """Neither package may import transformers or probe a host here: both raise their missing-stack error."""
    import torchmetrics_tpu.utils.pretrained as jpre

    import torchmetrics_tpu_torch.utils.pretrained as ppre

    for mod in (jpre, ppre):
        monkeypatch.setattr(mod, "_TRANSFORMERS_AVAILABLE", False)
        monkeypatch.setattr(mod, "_hub_reachable", lambda: False)
    monkeypatch.setitem(sys.modules, "transformers", None)


def _raises_alike(theirs, ours):
    with pytest.raises(Exception) as want:
        theirs()
    with pytest.raises(want.type) as got:
        ours()
    assert str(got.value) == str(want.value)


BERT_ERRORS = [
    ("unknown keyword", {"encoder": encoder, "idff": True}),
    ("all_layers with a plain encoder", {"encoder": encoder, "all_layers": True}),
    ("all_layers with user_forward_fn", {"own_model": "model", "user_tokenizer": "tok", "all_layers": True,
                                         "user_forward_fn": forward_fn}),
    ("encoder and hooks", {"encoder": encoder, "user_tokenizer": "tok"}),
    ("idf without tokenize", {"encoder": encoder, "idf": True}),
    ("own_model without a tokenizer", {"own_model": "model"}),
    ("lengths differ", {"encoder": encoder, "preds": ["a", "b"]}),
    ("default model, no transformers", {}),
    ("user_tokenizer, model from a checkpoint", {"user_tokenizer": "tok"}),
]


@pytest.mark.parametrize("case, kwargs", BERT_ERRORS, ids=[c[0] for c in BERT_ERRORS])
def test_bert_score_errors_match_jax(jax, monkeypatch, tmp_path, case, kwargs):
    _hf_off(monkeypatch, jax)
    kw = _bert_kwargs(kwargs, tmp_path)
    preds = kw.pop("preds", ["a b"])
    with pytest.warns(UserWarning) if case == "default model, no transformers" else _nothing():
        _raises_alike(lambda: jax.bert.bert_score(preds, ["a c"], **kw),
                      lambda: pft.bert_score(preds, ["a c"], device="cpu", **kw))


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("kwargs", [{"idf": True}, {"all_layers": True, "rescale_with_baseline": True}, {}],
                         ids=["idf", "all_layers", "plain"])
def test_bertscore_class_matches_jax(jax, tmp_path, kwargs):
    """``forward`` scores its batch alone, ``compute`` every sentence kept; ``reset`` clears them."""
    kw = dict(kwargs)
    if kw.get("all_layers"):
        kw.update(encoder=stacked_encoder, baseline_path=_baseline(tmp_path, ",", 3))
    else:
        kw.update(encoder=encoder, tokenize=tokenize)
    ours, theirs = pt.BERTScore(device="cpu", **kw), jax.text.BERTScore(**kw)
    for seed in range(3):
        batch = _pairs(seed, 5)
        _close(ours(*batch), theirs(*batch))
    _close(ours.compute(), theirs.compute())
    ours.reset()
    theirs.reset()
    batch = _pairs(9, 4)
    ours.update(*batch)
    theirs.update(*batch)
    _close(ours.compute(), theirs.compute())
    assert ours.device == torch.device("cpu") and not ours._state.tensors and not ours._state.lists


def test_bertscore_knobs_and_defaults_match_jax(jax, monkeypatch):
    """A callable bound positionally to an inert knob raises JAX's ``TypeError``; the HuggingFace default
    raises JAX's missing-stack error after its warning; ``baseline_url`` warns."""
    _raises_alike(lambda: jax.text.BERTScore(None, None, False, None, None, None, encoder),
                  lambda: pt.BERTScore(None, None, False, None, None, None, encoder))
    _raises_alike(lambda: jax.text.BERTScore(None, "12", encoder=encoder),
                  lambda: pt.BERTScore(None, "12", encoder=encoder, device="cpu"))
    _raises_alike(lambda: jax.text.BERTScore(encoder=encoder, batch_size=1.5),
                  lambda: pt.BERTScore(encoder=encoder, batch_size=1.5, device="cpu"))
    _raises_alike(lambda: jax.text.BERTScore(encoder=encoder, device=encoder),
                  lambda: pt.BERTScore(encoder=encoder, device=encoder))
    with pytest.warns(UserWarning, match="baseline_url"):
        pt.BERTScore(encoder=encoder, baseline_url="x", device="cpu")
    _hf_off(monkeypatch, jax)
    with pytest.warns(UserWarning, match="roberta-large"):
        _raises_alike(lambda: jax.text.BERTScore(), lambda: pt.BERTScore(device="cpu"))


# ------------------------------------------------------------------ InfoLM
MEASURES = [
    ("kl_divergence", None, None), ("alpha_divergence", 0.5, None), ("alpha_divergence", 2.5, None),
    ("alpha_divergence", -0.7, None), ("beta_divergence", None, 0.5), ("beta_divergence", None, 1.7),
    ("ab_divergence", 0.5, 1.5), ("ab_divergence", 1.3, -0.4), ("renyi_divergence", 0.5, None),
    ("renyi_divergence", 2.0, None), ("l1_distance", None, None), ("l2_distance", None, None),
    ("l_infinity_distance", None, None), ("fisher_rao_distance", None, None),
]


def _terms_scale(measure, preds, target, idf, alpha, beta):
    """The float64 magnitude of the terms each sentence's measure adds or subtracts: the scale of its
    float32 rounding where the terms cancel (a sentence scored against itself is 0 up to that rounding)."""
    from torchmetrics_tpu_torch.functional.text.infolm import _corpus_idf_weights, _sentence_distribution

    def bag(sents):
        probs, mask = (torch.as_tensor(x) for x in masked_lm(sents))
        w = _corpus_idf_weights(sents, tokenize, mask.shape[1], torch.device("cpu")) if idf else None
        return _sentence_distribution(probs, mask, w).double().numpy()

    p, q = bag(preds), bag(target)
    with np.errstate(divide="ignore", invalid="ignore"):  # an all-special row's empty bag: inf or NaN
        a, b = (1.0 if measure == "beta_divergence" else alpha), beta
        lsum = lambda x: np.abs(np.log(x.sum(-1)))  # noqa: E731
        if measure == "kl_divergence":
            return (q * (np.abs(np.log(p)) + np.abs(np.log(q)))).sum(-1)
        if measure == "alpha_divergence":
            return (1 + (q**a * p ** (1 - a)).sum(-1)) / abs(a * (a - 1))
        if measure in ("beta_divergence", "ab_divergence"):
            return lsum(q ** (a + b)) / abs(b * (a + b)) + lsum(p ** (a + b)) / abs(a * (a + b)) + lsum(q**a * p**b) / abs(a * b)
        if measure == "renyi_divergence":
            return lsum(q**a * p ** (1 - a)) / abs(a - 1)
        return np.abs(p).sum(-1) + np.abs(q).sum(-1)


def _close_infolm(got, want, scale):
    """Within 1e-5 relative, or 1e-6 of the terms' magnitude where they cancel."""
    (g_corpus, g_sent), (w_corpus, w_sent) = got, want
    for g, w, s in ((g_sent, w_sent, scale), (g_corpus, w_corpus, scale.mean())):
        g, w = g.numpy().astype(np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        with np.errstate(invalid="ignore"):
            ok = (g == w) | (np.abs(g - w) <= 1e-5 * np.abs(w) + 1e-6 * s) | (np.isnan(g) & np.isnan(w))
        assert ok.all(), (g, w, s)


@pytest.mark.parametrize("idf", [True, False])
@pytest.mark.parametrize("measure, alpha, beta", MEASURES, ids=[f"{m}-{a}-{b}" for m, a, b in MEASURES])
def test_infolm_measures_match_jax(jax, measure, alpha, beta, idf):
    preds, target = _pairs(len(measure), 6)
    kw = {"masked_lm": masked_lm, "tokenize": tokenize, "idf": idf, "information_measure": measure,
          "alpha": alpha, "beta": beta, "return_sentence_level_score": True}
    want = jax.infolm.infolm(preds, target, **kw)
    got = pft.infolm(preds, target, device="cpu", **kw)
    _close_infolm(got, want, _terms_scale(measure, preds, target, idf, alpha, beta))


INFOLM_REFUSED = [
    ("alpha_divergence", None, None), ("alpha_divergence", 1.0, None), ("alpha_divergence", 0.0, None),
    ("alpha_divergence", 1, None), ("beta_divergence", None, 0.0), ("beta_divergence", None, -1.0),
    ("beta_divergence", None, None), ("ab_divergence", 0.5, -0.5), ("ab_divergence", 0.0, 1.0),
    ("ab_divergence", 0.5, None), ("renyi_divergence", 1.0, None), ("renyi_divergence", None, None),
    ("cosine", None, None),
]


@pytest.mark.parametrize("measure, alpha, beta", INFOLM_REFUSED, ids=[f"{m}-{a}-{b}" for m, a, b in INFOLM_REFUSED])
def test_infolm_refused_parameters_match_jax(jax, measure, alpha, beta):
    kw = {"masked_lm": masked_lm, "tokenize": tokenize, "information_measure": measure, "alpha": alpha, "beta": beta}
    _raises_alike(lambda: jax.infolm.infolm(["a"], ["b"], **kw), lambda: pft.infolm(["a"], ["b"], device="cpu", **kw))
    _raises_alike(lambda: jax.text.InfoLM(**kw), lambda: pt.InfoLM(device="cpu", **kw))


@pytest.mark.parametrize("case, kwargs", [
    ("unknown keyword", {"masked_lm": masked_lm, "tokenize": tokenize, "temprature": 1.0}),
    ("temperature", {"masked_lm": masked_lm, "tokenize": tokenize, "temperature": 0}),
    ("idf without tokenize", {"masked_lm": masked_lm}),
    ("default model, no transformers", {}),
], ids=lambda x: x if isinstance(x, str) else "")
def test_infolm_errors_match_jax(jax, monkeypatch, case, kwargs):
    _hf_off(monkeypatch, jax)
    _raises_alike(lambda: jax.infolm.infolm(["a b"], ["a c"], **kwargs),
                  lambda: pft.infolm(["a b"], ["a c"], device="cpu", **kwargs))
    _raises_alike(lambda: jax.infolm.infolm(["a b", "c"], ["a c"], masked_lm=masked_lm, idf=False),
                  lambda: pft.infolm(["a b", "c"], ["a c"], masked_lm=masked_lm, idf=False, device="cpu"))
    if case != "unknown keyword":
        _raises_alike(lambda: jax.text.InfoLM(**kwargs), lambda: pt.InfoLM(device="cpu", **kwargs))


@pytest.mark.parametrize("measure, alpha, beta", [("kl_divergence", None, None), ("ab_divergence", 0.5, 1.5)],
                         ids=["kl", "ab"])
def test_infolm_class_matches_jax(jax, measure, alpha, beta):
    kw = {"masked_lm": masked_lm, "tokenize": tokenize, "information_measure": measure, "alpha": alpha,
          "beta": beta, "return_sentence_level_score": True}
    ours, theirs = pt.InfoLM(device="cpu", **kw), jax.text.InfoLM(**kw)
    preds, target = [], []
    for seed in range(3):
        batch = _pairs(seed + 20, 4)
        _close_infolm(ours(*batch), theirs(*batch), _terms_scale(measure, *batch, True, alpha, beta))
        preds, target = preds + batch[0], target + batch[1]
    _close_infolm(ours.compute(), theirs.compute(), _terms_scale(measure, preds, target, True, alpha, beta))
    _raises_alike(lambda: jax.text.InfoLM(masked_lm=masked_lm, tokenize=tokenize, verbose="yes"),
                  lambda: pt.InfoLM(masked_lm=masked_lm, tokenize=tokenize, verbose="yes"))


def test_encoder_metrics_default_to_cuda(monkeypatch):
    from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda **kw: pt.BERTScore(encoder=encoder, **kw), lambda **kw: pt.InfoLM(masked_lm=masked_lm, idf=False, **kw),
             lambda **kw: pft.bert_score(["a"], ["a"], encoder=encoder, **kw)["f1"],
             lambda **kw: pft.infolm(["a"], ["b"], masked_lm=masked_lm, idf=False, **kw)]
    for call in calls:
        with pytest.raises(TorchMetricsUserError, match="device='cpu'"):
            call()
        assert call(device="cpu").device == torch.device("cpu")


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_bert_score_at_a_mid_width_on_the_card(cuda_device):
    """A batch of 64 pairs at d = 768, L = 96, IDF weighted, against float64 on the host within 1e-5, and the
    same scores whatever TF32 flags the caller set."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    emb_p = torch.randn(64, 96, 768, device=cuda_device, generator=gen)
    emb_t = torch.randn(64, 80, 768, device=cuda_device, generator=gen)
    mask_p = (torch.rand(64, 96, device=cuda_device, generator=gen) > 0.2).long()
    mask_t = (torch.rand(64, 80, device=cuda_device, generator=gen) > 0.2).long()
    w_p = torch.rand(64, 96, device=cuda_device, generator=gen)
    emb_t = torch.nn.functional.pad(emb_t, (0, 0, 0, 16))
    mask_t = torch.nn.functional.pad(mask_t, (0, 16))
    got = _bert_score_from_embeddings(emb_p, mask_p, emb_t, mask_t, w_p, None)
    flags = torch.backends.cuda.matmul.fp32_precision
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    try:
        again = _bert_score_from_embeddings(emb_p, mask_p, emb_t, mask_t, w_p, None)
    finally:
        torch.backends.cuda.matmul.fp32_precision = flags
    p, t = (e.double().cpu().numpy() for e in (emb_p, emb_t))
    mp, mt = mask_p.cpu().numpy() > 0, mask_t.cpu().numpy() > 0
    p = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-12) * mp[..., None]
    t = t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12) * mt[..., None]
    cos = np.where(mp[:, :, None] & mt[:, None, :], np.einsum("bpd,brd->bpr", p, t), -1e9)
    wp = w_p.double().cpu().numpy() * mp
    precision = (cos.max(2) * wp).sum(-1) / wp.sum(-1)
    recall = (cos.max(1) * mt).sum(-1) / mt.sum(-1)
    for key, want in (("precision", precision), ("recall", recall)):
        np.testing.assert_allclose(got[key].cpu().numpy(), want, rtol=0, atol=1e-5)
        assert torch.equal(got[key], again[key])
