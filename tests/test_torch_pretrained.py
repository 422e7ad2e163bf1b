"""The port's pretrained-model adapters (``utils/pretrained.py``) against the JAX package's.

No weights are downloaded and no checkpoint is asked for. What is held:

- each adapter's ``ModuleNotFoundError`` where its stack is absent, word for word JAX's (the
  availability flags patched off in both packages);
- ``torch_bert_encoder`` over a 2-layer ``BertModel`` built in-process gives JAX's adapter's hidden
  states and masks (the same torch model runs in both: equal bits) and tokens, with ``num_layers``,
  ``all_layers`` and a ``forward_fn``; skipped without ``transformers``.

The checkpoint loaders (``bert_encoder``, ``hf_bert_model_and_tokenizer``, ``clip_encoders``) are held
here to their no-package messages only: importing transformers' ``AutoModel`` costs about 8 s on a CPU
test runner, and its CLIP processors about 14 s, beyond this file's share of the suite's time.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from torchmetrics_tpu_torch.utils import pretrained as pp

WORDS = ["the", "cat", "sat", "on", "mat", "dog", "ran", "fast", "hello", "there", "##s", "##ing"]
SENTENCES = ["the cat sat on the mat", "hello there", "the dog ran fast cats"]


@pytest.fixture(scope="module")
def jp():
    pytest.importorskip("jax")
    import torchmetrics_tpu.utils.pretrained as jp_

    return jp_


@pytest.fixture(scope="module")
def tiny_bert(tmp_path_factory):
    """A 2-layer randomly initialised BERT and a WordPiece tokenizer."""
    pytest.importorskip("transformers")
    from transformers import BertConfig, BertModel, BertTokenizerFast

    d = str(tmp_path_factory.mktemp("tiny_bert"))
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list("abcdefghijklmnopqrstuvwxyz") + WORDS
    with open(os.path.join(d, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab))
    tokenizer = BertTokenizerFast(vocab_file=os.path.join(d, "vocab.txt"), do_lower_case=True)
    config = BertConfig(vocab_size=len(vocab), hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=32, max_position_embeddings=32)
    torch.manual_seed(0)
    return BertModel(config).eval(), tokenizer


def _raises_alike(jcall, pcall):
    with pytest.raises(Exception) as jerr:
        jcall()
    with pytest.raises(type(jerr.value)) as perr:
        pcall()
    assert str(perr.value) == str(jerr.value)
    return perr.value


def test_probes_read_what_jax_reads(jp):
    for flag in ("_TORCH_AVAILABLE", "_TORCH_FIDELITY_AVAILABLE", "_TORCHVISION_AVAILABLE", "_LPIPS_AVAILABLE",
                 "_TRANSFORMERS_AVAILABLE"):
        assert getattr(pp, flag) == getattr(jp, flag), flag
    assert pp.hf_model_cached("no-such-org/no-such-model") is jp.hf_model_cached("no-such-org/no-such-model") is False


@pytest.mark.parametrize("adapter, args, flags", [
    ("inception_feature_extractor", (2048, "FrechetInceptionDistance"), {"_TORCH_FIDELITY_AVAILABLE": False}),
    ("inception_feature_extractor", ("logits_unbiased", "InceptionScore"), {"_TORCH_FIDELITY_AVAILABLE": False}),
    ("lpips_network", ("alex",), {"_TORCHVISION_AVAILABLE": False}),
    ("lpips_network", ("vgg",), {"_TORCHVISION_AVAILABLE": True, "_LPIPS_AVAILABLE": False}),
    ("clip_encoders", ("openai/clip-vit-base-patch32",), {"_TRANSFORMERS_AVAILABLE": False}),
    ("hf_bert_model_and_tokenizer", ("bert-base-uncased",), {"_TRANSFORMERS_AVAILABLE": False}),
    ("bert_encoder", ("bert-base-uncased",), {"_TRANSFORMERS_AVAILABLE": False}),
])
def test_no_package_messages_word_for_word(jp, monkeypatch, adapter, args, flags):
    for module in (jp, pp):
        for flag, value in flags.items():
            monkeypatch.setattr(module, flag, value)
    err = _raises_alike(lambda: getattr(jp, adapter)(*args), lambda: getattr(pp, adapter)(*args))
    assert isinstance(err, ModuleNotFoundError)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("kwargs", [{}, {"num_layers": 1}, {"all_layers": True},
                                    {"forward_fn": lambda model, batch: model(**batch).last_hidden_state * 2}])
def test_torch_bert_encoder_matches_jax(jp, tiny_bert, kwargs):
    model, tokenizer = tiny_bert
    jenc, jtok = jp.torch_bert_encoder(model, tokenizer, max_length=16, **kwargs)
    penc, ptok = pp.torch_bert_encoder(model, tokenizer, max_length=16, device="cpu", **kwargs)
    (jh, jm), (ph, pm) = jenc(SENTENCES), penc(SENTENCES)
    assert isinstance(ph, torch.Tensor) and ph.device == torch.device("cpu")
    assert np.array_equal(_np(ph), np.asarray(jh)) and np.array_equal(_np(pm), np.asarray(jm))
    assert penc.layer_stacked is jenc.layer_stacked is bool(kwargs.get("all_layers"))
    for got, want in zip(ptok(SENTENCES), jtok(SENTENCES)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
