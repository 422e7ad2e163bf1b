"""The port's 14 text classes (``text/``) against the JAX package's.

Each class goes through ``forward`` on three batches of seeded stand-in sentences (each batch's value
against JAX's forward) and ``compute`` (against JAX's), under its options; the states are held to JAX's
(counts exactly, scores within 1e-6, perplexity within 1e-5 relative, NaN where JAX gives NaN: the
computes of JAX's classes keep their 1e-38 guards). On the emulated graph tier
(``dispatch.EMULATE_ON_CPU``) the string updates stay eager (``jit_update_off`` where ``fast_update`` is
asked for), the edit-distance updates replay one row-scan graph per padded shape, Perplexity's update is
one capture and then a replay a step, and every value is the eager tier's bits. The ``cuda`` tests run
the row scan and Perplexity at a mid width on both tiers of the card:

    python -m pytest --noconftest tests/test_torch_text_classes.py -m cuda
"""
from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torchmetrics_tpu_torch.text as pt
from torchmetrics_tpu_torch.functional.text import _edit
from torchmetrics_tpu_torch.ops import dispatch
from torch_text_corpus import hypotheses, sentences

TOL = 1e-6


@pytest.fixture(scope="module")
def jax():
    pytest.importorskip("jax")
    import torchmetrics_tpu.functional.text.rouge as jrouge
    import torchmetrics_tpu.text as jt

    saved = jrouge._PUNKT_AVAILABLE
    jrouge._PUNKT_AVAILABLE = False  # no network probe, no download: the regex split, as the port's here
    yield SimpleNamespace(text=jt)
    jrouge._PUNKT_AVAILABLE = saved


def _close(got, want, tol=TOL):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            _close(got[key], want[key], tol)
        return
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


def _mt_batches(seed: int):
    refs = sentences(seed, 18, empty_every=7)
    refs2 = sentences(seed + 1, 18)
    hyps = hypotheses(refs, seed + 2)
    return [(hyps[i:i + 6], [[a, b] for a, b in zip(refs[i:i + 6], refs2[i:i + 6])]) for i in range(0, 18, 6)]


def _asr_batches(seed: int):
    refs = [s.upper() for s in sentences(seed, 18, empty_every=9)]
    hyps = hypotheses(refs, seed + 1)
    return [(hyps[i:i + 6], refs[i:i + 6]) for i in range(0, 18, 6)]


def _summaries(seed: int):
    a, b, c = sentences(seed, 12), sentences(seed + 1, 12), sentences(seed + 2, 12)
    preds = [f"{x}. {y}!" for x, y in zip(hypotheses(a, seed + 3), b)]
    target = [[f"{x}. {y}", f"{z}. {x}?"] for x, y, z in zip(a, b, c)]
    return [(preds[i:i + 4], target[i:i + 4]) for i in range(0, 12, 4)]


def _squad_batches(seed: int):
    rng = np.random.RandomState(seed)
    answers = sentences(seed, 24, max_words=4)
    out = []
    for i in range(0, 24, 8):
        preds = [{"prediction_text": a if rng.rand() < 0.5 else answers[(j + 3) % 24], "id": str(j)}
                 for j, a in enumerate(answers[i:i + 8], i) if j % 5]
        target = [{"answers": {"answer_start": [0], "text": [a, answers[(j + 1) % 24]]}, "id": str(j)}
                  for j, a in enumerate(answers[i:i + 8], i)]
        out.append((preds, target))
    return out


def _perplexity_batches(seed: int, ignore_index=None):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(3):
        logits = (rng.randn(2, 9, 40) * 3).astype(np.float32)
        target = rng.randint(0, 40, (2, 9))
        if ignore_index is not None:
            target[:, :4] = ignore_index
        out.append((logits, target))
    return out


#: (class, constructor arguments, batches, tolerance)
CASES = [
    ("BLEUScore", {}, _mt_batches(1), TOL),
    ("BLEUScore", {"n_gram": 2, "smooth": True, "weights": [0.7, 0.3]}, _mt_batches(2), TOL),
    ("SacreBLEUScore", {"tokenize": "13a", "lowercase": True}, _mt_batches(3), TOL),
    ("SacreBLEUScore", {"tokenize": "char", "n_gram": 3}, _mt_batches(4), TOL),
    ("SacreBLEUScore", {"tokenize": "zh"}, _mt_batches(5), TOL),
    ("CHRFScore", {}, _mt_batches(6), TOL),
    ("CHRFScore", {"n_word_order": 0, "return_sentence_level_score": True, "whitespace": True}, _mt_batches(7), TOL),
    ("TranslationEditRate", {}, _mt_batches(8), TOL),
    ("TranslationEditRate", {"normalize": True, "no_punctuation": True, "return_sentence_level_score": True},
     _mt_batches(9), TOL),
    ("ExtendedEditDistance", {}, _mt_batches(10), TOL),
    ("ExtendedEditDistance", {"return_sentence_level_score": True, "alpha": 1.5, "deletion": 0.3}, _mt_batches(11), TOL),
    ("WordErrorRate", {}, _asr_batches(12), TOL),
    ("CharErrorRate", {}, _asr_batches(13), TOL),
    ("MatchErrorRate", {}, _asr_batches(14), TOL),
    ("WordInfoLost", {}, _asr_batches(15), TOL),
    ("WordInfoPreserved", {}, _asr_batches(16), TOL),
    ("EditDistance", {}, _asr_batches(17), TOL),
    ("EditDistance", {"substitution_cost": 2, "reduction": "sum"}, _asr_batches(18), TOL),
    ("EditDistance", {"reduction": "none"}, _asr_batches(19), TOL),
    ("ROUGEScore", {}, _summaries(20), TOL),
    ("ROUGEScore", {"accumulate": "avg", "rouge_keys": ("rouge2", "rougeLsum")}, _summaries(21), TOL),
    ("SQuAD", {}, _squad_batches(22), TOL),
    ("Perplexity", {}, _perplexity_batches(23), 1e-5),
    ("Perplexity", {"ignore_index": -100}, _perplexity_batches(24, -100), 1e-5),
]


def _run(metric, batches, port: bool):
    """Each batch's forward value, then the compute; the port takes the logits as tensors."""
    as_args = (lambda b: tuple(torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in b)) if port else tuple
    values = [metric(*as_args(b)) for b in batches]
    return values, metric.compute()


@pytest.mark.parametrize("name, kwargs, batches, tol", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_class_against_jax(jax, name, kwargs, batches, tol):
    ours = getattr(pt, name)(**kwargs, device="cpu")
    theirs = getattr(jax.text, name)(**kwargs)
    got_values, got = _run(ours, batches, True)
    want_values, want = _run(theirs, batches, False)
    for g, w in zip(got_values, want_values):
        _close(g, w, tol)
    _close(got, want, tol)
    state = ours.metric_state
    for key in theirs._defaults:
        value = getattr(theirs, key)
        if isinstance(value, list):
            want_state = np.concatenate([np.asarray(v).reshape(-1) for v in value]) if value else np.zeros(0)
            got_state = torch.cat([v.reshape(-1) for v in state[key]]).numpy() if state[key] else np.zeros(0)
        else:
            want_state, got_state = np.asarray(value), state[key].numpy()
        _close(got_state, want_state, tol)


@pytest.mark.parametrize("name", ["BLEUScore", "CHRFScore", "WordErrorRate", "MatchErrorRate", "WordInfoLost",
                                  "TranslationEditRate", "ExtendedEditDistance", "SQuAD", "ROUGEScore"])
def test_degenerate_updates_as_jax(jax, name):
    """Empty batches and empty strings: the zero denominators that JAX's 1e-38 guards meet, NaN where JAX
    gives NaN."""
    feeds = {"SQuAD": ([], []), "ROUGEScore": ([""], [[""]])}
    batch = feeds.get(name, ([""], [[""]] if name in ("BLEUScore", "CHRFScore", "TranslationEditRate",
                                                      "ExtendedEditDistance") else [""]))
    ours, theirs = getattr(pt, name)(device="cpu"), getattr(jax.text, name)()
    for metric in (ours, theirs):
        metric.update(*batch)
    _close(ours.compute(), theirs.compute())


@pytest.mark.parametrize("name, kwargs", [("EditDistance", {"reduction": "none"}), ("EditDistance", {}),
                                          ("CHRFScore", {"return_sentence_level_score": True}), ("CHRFScore", {}),
                                          ("TranslationEditRate", {"return_sentence_level_score": True}),
                                          ("ExtendedEditDistance", {}), ("ROUGEScore", {}), ("BLEUScore", {}),
                                          ("WordErrorRate", {}), ("SQuAD", {}), ("Perplexity", {})])
def test_compute_before_update_as_jax(jax, name, kwargs):
    """A compute before any update: the same value as JAX's, or the same exception (a list state with no
    entry cannot be concatenated)."""
    ours, theirs = getattr(pt, name)(**kwargs, device="cpu"), getattr(jax.text, name)(**kwargs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # both warn that compute comes before update; JAX's warns once a process
        try:
            want, want_err = theirs.compute(), None
        except ValueError as err:
            want, want_err = None, str(err)
        if want_err is not None:
            with pytest.raises(ValueError, match=want_err):
                ours.compute()
            return
        got = ours.compute()
    _close(got, want)


def test_perplexity_and_edit_distance_on_the_emulated_graph_tier(monkeypatch):
    monkeypatch.setattr(dispatch, "EMULATE_ON_CPU", True)
    monkeypatch.setattr(_edit, "_GRAPHS", {})
    results = {}
    for tier in ("graph", "eager"):
        if tier == "eager":
            monkeypatch.setenv("TM_TPU_FAST_DISPATCH", "0")
        dispatch.STATS.reset()
        ppl = pt.Perplexity(ignore_index=-100, device="cpu")
        ppl.fast_update = True
        for logits, target in _perplexity_batches(3, -100):
            ppl.update(torch.from_numpy(logits), torch.from_numpy(target))
        cer = pt.CharErrorRate(device="cpu")
        cer.fast_update = True
        for preds, target in _asr_batches(4):
            cer.update(preds, target)
        results[tier] = (ppl.compute(), cer.compute())
        fallbacks = sorted({(op, reason) for (_, op, reason) in dispatch.STATS.fallbacks})
        if tier == "graph":
            # Perplexity: one capture, then a replay an update; CER: one row-scan graph per padded shape
            assert ("update", "jit_update_off") in fallbacks and len(fallbacks) == 1
            shapes = {_edit.padded_ids([list(p) for p in b[0]], [list(t) for t in b[1]])[0].shape
                      + _edit.padded_ids([list(p) for p in b[0]], [list(t) for t in b[1]])[2].shape
                      for b in _asr_batches(4)}
            assert dispatch.STATS.captures == 1 + len(shapes)
            assert dispatch.STATS.replays == 3 + 3
    for g, e in zip(results["graph"], results["eager"]):
        assert torch.equal(g, e)


def test_host_classes_keep_jax_s_flags():
    for name in pt.__all__:
        cls = getattr(pt, name)
        if name == "Perplexity":
            assert cls.jit_update and not cls.full_state_update and cls.is_differentiable
        else:
            assert not cls.jit_update and cls.full_state_update and not cls.is_differentiable


def test_constructor_errors_as_jax(jax):
    cases = [("BLEUScore", {"n_gram": 2, "weights": [1.0]}), ("SacreBLEUScore", {"tokenize": "ko-mecab"}),
             ("SacreBLEUScore", {"tokenize": "nope"}), ("CHRFScore", {"n_char_order": 0}),
             ("TranslationEditRate", {"lowercase": "yes"}), ("ExtendedEditDistance", {"language": "fr"}),
             ("ExtendedEditDistance", {"rho": 1}), ("EditDistance", {"substitution_cost": -1}),
             ("EditDistance", {"reduction": "max"}), ("ROUGEScore", {"rouge_keys": ("rougeX",)}),
             ("ROUGEScore", {"accumulate": "worst"}), ("Perplexity", {"ignore_index": 1.5})]
    for name, kwargs in cases:
        with pytest.raises(ValueError) as theirs:
            getattr(jax.text, name)(**kwargs)
        with pytest.raises(ValueError) as ours:
            getattr(pt, name)(**kwargs, device="cpu")
        assert str(ours.value) == str(theirs.value), name


def test_text_metrics_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in pt.__all__:
        with pytest.raises(Exception, match="device='cpu'"):
            getattr(pt, name)()


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_row_scan_graph_is_the_eager_bits_on_the_card(cuda_device, monkeypatch):
    rng = np.random.RandomState(0)
    preds = [list(rng.randint(0, 30, rng.randint(0, 300))) for _ in range(50)]
    target = [list(rng.randint(0, 30, rng.randint(0, 300))) for _ in range(50)]
    want = [float(x) for x in _edit.edit_distance_batch(preds, target, device="cpu")]
    monkeypatch.setattr(_edit, "_GRAPHS", {})
    dispatch.STATS.reset()
    graph = [_edit.edit_distance_batch(preds, target, 2.0 if i else 1.0, device=cuda_device) for i in range(3)]
    assert dispatch.STATS.captures == 2 and dispatch.STATS.replays == 3
    monkeypatch.setenv("TM_TPU_FAST_DISPATCH", "0")
    eager = _edit.edit_distance_batch(preds, target, 1.0, device=cuda_device)
    assert torch.equal(graph[0], eager) and graph[0].cpu().tolist() == want
    assert torch.equal(graph[1], graph[2])


@pytest.mark.cuda
def test_perplexity_at_a_mid_width_on_the_card(cuda_device, monkeypatch):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    logits = torch.randn(4, 256, 8192, device=cuda_device, generator=gen) * 3
    target = torch.randint(0, 8192, (4, 256), device=cuda_device, generator=gen)
    target[:, :64] = -100
    want = torch.exp(-torch.nn.functional.log_softmax(logits.double(), -1).gather(-1, target.clamp_min(0)[..., None])
                     [..., 0][target != -100].mean())
    values = {}
    for tier in ("graph", "eager"):
        if tier == "eager":
            monkeypatch.setenv("TM_TPU_FAST_DISPATCH", "0")
        m = pt.Perplexity(ignore_index=-100, device=cuda_device)
        m.fast_update = True
        for _ in range(3):
            m.update(logits, target)
        values[tier] = m.compute()
    assert torch.equal(values["graph"], values["eager"])
    np.testing.assert_allclose(float(values["graph"]), float(want), rtol=1e-5)
