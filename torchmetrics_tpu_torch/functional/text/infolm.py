"""InfoLM (counterpart of ``torchmetrics_tpu/functional/text/infolm.py``).

InfoLM averages the masked-language-model distributions of a sentence's positions into one bag
per sentence (a weighted mean over the real positions) and compares the candidate's bag with the
reference's under an information measure. The model is the caller's callable

    ``masked_lm(sentences: List[str]) -> (probs (N, L, V), mask (N, L))``

giving, per position, the MLM distribution with that position masked, and 1 in ``mask`` for the real,
non-special positions; a locally cached HuggingFace ``model_name_or_path`` builds one. The bags and the
nine measures run on ``device`` (CUDA unless named) in float32, with JAX's conventions and clips.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.bert import _as_tensor, _idf_weights, _pad_seq, _tokens_idf
from torchmetrics_tpu_torch.metric import resolve_device

MaskedLM = Callable[[List[str]], Tuple[Tensor, Tensor]]

_ALLOWED_INFORMATION_MEASURE = (
    "kl_divergence",
    "alpha_divergence",
    "beta_divergence",
    "ab_divergence",
    "renyi_divergence",
    "l1_distance",
    "l2_distance",
    "l_infinity_distance",
    "fisher_rao_distance",
)

_EPS = 1e-12
#: the reference's knobs that change nothing here (its own batching and progress)
_INERT = frozenset({"batch_size", "num_threads", "verbose"})


def _validate_measure(information_measure: str, alpha: Optional[float], beta: Optional[float]) -> None:
    """The parameter constraints of the divergences (JAX ``infolm.py:38``), with its messages."""
    if information_measure not in _ALLOWED_INFORMATION_MEASURE:
        raise ValueError(
            f"Argument `information_measure` expected to be one of {_ALLOWED_INFORMATION_MEASURE},"
            f" got {information_measure}"
        )
    needs_alpha = information_measure in ("alpha_divergence", "ab_divergence", "renyi_divergence")
    needs_beta = information_measure in ("beta_divergence", "ab_divergence")
    if needs_alpha and not isinstance(alpha, float):
        raise ValueError(f"Parameter `alpha` is expected to be defined for {information_measure}.")
    if needs_beta and not isinstance(beta, float):
        raise ValueError(f"Parameter `beta` must be defined for {information_measure}.")
    if information_measure == "alpha_divergence" and alpha in (0.0, 1.0):
        raise ValueError(f"Parameter `alpha` is expected to be float differened from 0 and 1 for {information_measure}.")
    if information_measure == "beta_divergence" and beta in (0.0, -1.0):
        raise ValueError(f"Parameter `beta` must be float differened from 0 and -1 for {information_measure}.")
    if information_measure == "ab_divergence" and (alpha is None or beta is None or 0.0 in (alpha, beta, alpha + beta)):
        raise ValueError(
            "Parameters `alpha`, `beta` and their sum are expected to be differened from 0 for ab_divergence"
        )
    if information_measure == "renyi_divergence" and alpha == 1.0:
        raise ValueError(f"Parameter `alpha` is expected to be float differened from 1 for {information_measure}.")


def _ab(p: Tensor, q: Tensor, a: float, b: float) -> Tensor:
    """The AB-divergence with JAX's (and the reference's) placement of ``p`` and ``q``."""
    return (
        torch.log(torch.sum(q ** (a + b), dim=-1)) / (b * (a + b))
        + torch.log(torch.sum(p ** (a + b), dim=-1)) / (a * (a + b))
        - torch.log(torch.sum(q**a * p**b, dim=-1)) / (a * b)
    )


def _information_measure(p: Tensor, q: Tensor, information_measure: str, alpha: Optional[float],
                         beta: Optional[float]) -> Tensor:
    """One divergence per row over the vocabulary axis, ``p`` the preds' bag and ``q`` the target's
    (JAX ``infolm.py:67``): kl is the sign-flipped Σ q·log(p/q); beta is ab with α pinned to 1; renyi
    weighs q^α·p^(1-α); fisher-rao clips its cosine to [0, 1]. No other clip: the bags are strictly
    positive softmax means."""
    p = p.to(torch.float32)
    q = q.to(torch.float32)
    if information_measure == "kl_divergence":
        return torch.sum(q * (torch.log(p) - torch.log(q)), dim=-1)
    if information_measure == "alpha_divergence":
        a = alpha  # the denominator α(α-1) is negative on (0, 1), the reference's convention
        return (1 - torch.sum(q**a * p ** (1 - a), dim=-1)) / (a * (a - 1))
    if information_measure == "beta_divergence":
        return _ab(p, q, 1.0, beta)
    if information_measure == "ab_divergence":
        return _ab(p, q, alpha, beta)
    if information_measure == "renyi_divergence":
        a = alpha
        return torch.log(torch.sum(q**a * p ** (1 - a), dim=-1)) / (a - 1)
    if information_measure == "l1_distance":
        return torch.sum(torch.abs(p - q), dim=-1)
    if information_measure == "l2_distance":
        return torch.sqrt(torch.sum(torch.square(p - q), dim=-1))
    if information_measure == "l_infinity_distance":
        return torch.amax(torch.abs(p - q), dim=-1)
    return 2 * torch.arccos(torch.clamp(torch.sum(torch.sqrt(p * q), dim=-1), 0.0, 1.0))


def _sentence_distribution(probs: Tensor, mask: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """The weighted mean of the per-position distributions: one ``(V,)`` bag per sentence (JAX
    ``infolm.py:113``); ``weights`` (idf) multiply the position mask."""
    probs = probs.to(torch.float32)
    w = mask.to(torch.float32)
    if weights is not None:
        w = w * weights.to(torch.float32)
    total = torch.sum(probs * w[..., None], dim=1)
    return total / torch.clamp(torch.sum(w, dim=1), min=_EPS)[..., None]


def _hf_masked_lm(model_name_or_path: str, max_length: Optional[int] = None, temperature: float = 1.0,
                  device=None):
    """``(masked_lm, tokenize)`` over a cached HuggingFace checkpoint, the model on ``device`` (JAX
    ``infolm.py:128``): position ``i``'s distribution comes from a pass with position ``i`` replaced by
    ``[MASK]`` (L masked copies a batch), ``softmax(logits / temperature)``; the distributions and the
    mask come back as tensors on ``device``."""
    dev = resolve_device(device)
    try:
        from transformers import AutoModelForMaskedLM, AutoTokenizer

        from torchmetrics_tpu_torch.utils.pretrained import _from_pretrained

        tokenizer = _from_pretrained(AutoTokenizer, model_name_or_path)
        model = _from_pretrained(AutoModelForMaskedLM, model_name_or_path)
        model.eval()
    except Exception as err:  # noqa: BLE001 - every loading failure gets the one message
        raise ModuleNotFoundError(
            f"Loading checkpoint {model_name_or_path!r} failed (no local cache and no network egress"
            " in this build). Pass a `masked_lm` callable `(sentences) -> (probs, mask)` instead."
        ) from err
    model = model.to(dev)
    mask_id = tokenizer.mask_token_id
    if max_length is None:
        # the reference's default: the generation config's max_length (20 for BERT), not the
        # tokenizer's model_max_length
        max_length = int(model.config.max_length)

    def _batch(sentences: List[str], kind: str):
        # padding="max_length" keeps the reference's fixed grid
        return tokenizer(sentences, return_tensors=kind, padding="max_length", truncation=True,
                         max_length=max_length, return_special_tokens_mask=True)

    def tokenize(sentences: List[str]):
        batch = _batch(sentences, "np")
        mask = batch["attention_mask"] * (1 - batch["special_tokens_mask"])
        return np.asarray(batch["input_ids"], np.int64), np.asarray(mask)

    def masked_lm(sentences: List[str]) -> Tuple[Tensor, Tensor]:
        batch = _batch(sentences, "pt")
        special = batch.pop("special_tokens_mask")
        ids, attn = batch["input_ids"].to(dev), batch["attention_mask"].to(dev)
        rows = []
        with torch.no_grad():
            for pos in range(ids.shape[1]):
                masked_ids = ids.clone()
                masked_ids[:, pos] = mask_id
                logits = model(masked_ids, attn).logits[:, pos, :]
                rows.append(torch.softmax(logits / temperature, dim=-1))
        return torch.stack(rows, dim=1), attn * (1 - special.to(dev))

    return masked_lm, tokenize


def _corpus_idf_weights(sentences: List[str], tokenize, width: int, device: torch.device) -> Tensor:
    """Per-position idf weights over a corpus's own sentences (JAX ``infolm.py:189``)."""
    ids, mask = tokenize(list(sentences))
    w = torch.from_numpy(_idf_weights(ids, _tokens_idf(ids, mask))).to(device)
    return _pad_seq(w, 1, max(0, width - w.shape[1]))[:, :width]


def infolm(
    preds: Union[str, List[str]],
    target: Union[str, List[str]],
    model_name_or_path: str = "bert-base-uncased",
    temperature: float = 0.25,
    information_measure: str = "kl_divergence",
    idf: bool = True,
    alpha: Optional[float] = None,
    beta: Optional[float] = None,
    masked_lm: Optional[MaskedLM] = None,
    tokenize=None,
    max_length: Optional[int] = None,
    return_sentence_level_score: bool = False,
    device=None,
    **reference_kwargs,
):
    """InfoLM (JAX ``infolm.py:202``): an information measure between the MLM bags, on ``device``.

    The reference's defaults: ``bert-base-uncased``, ``temperature=0.25``, ``idf=True``. A ``masked_lm``
    callable replaces the HuggingFace model; with ``idf=True`` it needs a ``tokenize`` callable. ``device``
    is where the scores live (CUDA unless named); ``batch_size``, ``num_threads`` and ``verbose`` are
    accepted and inert, and any other keyword raises ``TypeError``.
    """
    _validate_measure(information_measure, alpha, beta)
    if not (isinstance(temperature, (int, float)) and temperature > 0):
        raise ValueError(f"Argument `temperature` must be a positive number, but got {temperature}")
    unknown = sorted(set(reference_kwargs) - _INERT)
    if unknown:
        raise TypeError(f"infolm() got unexpected keyword arguments {unknown}")
    dev = resolve_device(device)
    preds = [preds] if isinstance(preds, str) else list(preds)
    target = [target] if isinstance(target, str) else list(target)
    if len(preds) != len(target):
        raise ValueError(f"Number of predicted and reference sentences must match: {len(preds)} != {len(target)}")
    if masked_lm is None:
        masked_lm, tokenize = _hf_masked_lm(model_name_or_path, max_length=max_length, temperature=temperature,
                                            device=dev)
    if idf and tokenize is None:
        raise ValueError(
            "`idf=True` needs token ids: pass `tokenize` alongside a custom `masked_lm`, or use a"
            " HuggingFace `model_name_or_path` so the tokenizer is resolved automatically."
        )
    p_probs, p_mask = (_as_tensor(x, dev) for x in masked_lm(list(preds)))
    t_probs, t_mask = (_as_tensor(x, dev) for x in masked_lm(list(target)))
    p_w = _corpus_idf_weights(preds, tokenize, p_mask.shape[1], dev) if idf else None
    t_w = _corpus_idf_weights(target, tokenize, t_mask.shape[1], dev) if idf else None
    p_bag = _sentence_distribution(p_probs, p_mask, p_w)
    t_bag = _sentence_distribution(t_probs, t_mask, t_w)
    sentence = _information_measure(p_bag, t_bag, information_measure, alpha, beta)
    corpus = torch.mean(sentence)
    if return_sentence_level_score:
        return corpus, sentence
    return corpus
