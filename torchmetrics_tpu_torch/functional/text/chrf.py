"""chrF and chrF++ (counterpart of ``torchmetrics_tpu/functional/text/chrf.py``, reference
``functional/text/chrf.py``).

The JAX package's state layout: six fixed-shape vectors indexed by ``n - 1`` (the reference keeps
six dicts of scalars, ``chrf.py:48-79``), char orders ``(n_char_order,)`` and word orders
``(n_word_order,)``. Counting is host string work, the vectorised ``_chrf_score_update_batched``
(numpy only, copied), whose sentence F-scores stay in numpy (``_fscore_np``); the corpus F-score is
tensor code on the device. Its ``jnp.maximum(x, 1e-38)`` guards sit under a ``where`` that masks
them, so :func:`~torchmetrics_tpu_torch.utils.compute._flushed_floor` gives the same value either way.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import resolve_device
from torchmetrics_tpu_torch.utils.compute import _flushed_floor

_EPS_SMOOTHING = 1e-16
_PUNCTUATIONS = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")


def _get_characters(sentence: str, whitespace: bool) -> List[str]:
    """Reference ``chrf.py:81``."""
    if whitespace:
        return list(sentence)
    return list(sentence.strip().replace(" ", ""))


def _separate_word_and_punctuation(word: str) -> List[str]:
    """Reference ``chrf.py:97``."""
    if len(word) == 1:
        return [word]
    if word[-1] in _PUNCTUATIONS:
        return [word[:-1], word[-1]]
    if word[0] in _PUNCTUATIONS:
        return [word[0], word[1:]]
    return [word]


def _get_words_and_punctuation(sentence: str) -> List[str]:
    """Reference ``chrf.py:120``."""
    return sum((_separate_word_and_punctuation(word) for word in sentence.strip().split()), [])


def _calculate_fscore(
    matching_char_n_grams: Tensor,
    matching_word_n_grams: Tensor,
    hyp_char_n_grams: Tensor,
    hyp_word_n_grams: Tensor,
    ref_char_n_grams: Tensor,
    ref_word_n_grams: Tensor,
    n_order: float,
    beta: float,
) -> Tensor:
    """The masked F-beta over all orders at once (``chrf.py:78``)."""

    def _fscore(match: Tensor, hyp: Tensor, ref: Tensor) -> Tensor:
        precision = torch.where(hyp > 0, match / _flushed_floor(hyp), 0.0)
        recall = torch.where(ref > 0, match / _flushed_floor(ref), 0.0)
        denominator = torch.clamp_min(beta**2 * precision + recall, _EPS_SMOOTHING)
        return (1 + beta**2) * precision * recall / denominator

    char_f = _fscore(matching_char_n_grams, hyp_char_n_grams, ref_char_n_grams)
    word_f = _fscore(matching_word_n_grams, hyp_word_n_grams, ref_word_n_grams)
    return (torch.sum(char_f) + torch.sum(word_f)) / n_order


def _chrf_score_compute(totals: Dict[str, Tensor], n_order: float, beta: float) -> Tensor:
    """The corpus score from the six vectors (``chrf.py:167``)."""
    return _calculate_fscore(
        totals["matching_char"],
        totals["matching_word"],
        totals["preds_char"],
        totals["preds_word"],
        totals["target_char"],
        totals["target_word"],
        n_order,
        beta,
    )


def _validate_chrf_args(n_char_order: int, n_word_order: int, beta: float) -> None:
    if not isinstance(n_char_order, int) or n_char_order < 1:
        raise ValueError('Argument `n_char_order` must be an integer greater than or equal to 1.')
    if not isinstance(n_word_order, int) or n_word_order < 0:
        raise ValueError('Argument `n_word_order` must be an integer greater than or equal to 0.')
    if beta < 0:
        raise ValueError('Argument `beta` must be greater than 0.')


def chrf_score(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    n_char_order: int = 6,
    n_word_order: int = 2,
    beta: float = 2.0,
    lowercase: bool = False,
    whitespace: bool = False,
    return_sentence_level_score: bool = False,
    device: Union[str, torch.device, None] = None,
):
    """chrF and chrF++ (``chrf.py:190``): ``n_word_order=2`` gives chrF++, 0 gives chrF. On ``device``
    (CUDA unless named).

    Example:
        >>> from torchmetrics_tpu_torch.functional import chrf_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat']]
        >>> print(f"{float(chrf_score(preds, target, device='cpu')):.4f}")
        0.4942
    """
    _validate_chrf_args(n_char_order, n_word_order, beta)
    device = resolve_device(device)
    n_order = float(n_char_order + n_word_order)
    totals = {
        "preds_char": np.zeros(n_char_order, np.float32),
        "preds_word": np.zeros(n_word_order, np.float32),
        "target_char": np.zeros(n_char_order, np.float32),
        "target_word": np.zeros(n_word_order, np.float32),
        "matching_char": np.zeros(n_char_order, np.float32),
        "matching_word": np.zeros(n_word_order, np.float32),
    }
    sentence_scores: Optional[List[float]] = [] if return_sentence_level_score else None
    _chrf_score_update_batched(
        preds, target, totals, n_char_order, n_word_order, n_order, beta, lowercase, whitespace, sentence_scores
    )
    score = _chrf_score_compute({k: torch.from_numpy(v).to(device) for k, v in totals.items()}, n_order, beta)
    if return_sentence_level_score:
        return score, torch.tensor(sentence_scores, dtype=torch.float32, device=device)
    return score


def _domain_stats_batched(
    pred_streams: List[List[str]],
    ref_streams: List[List[str]],
    ref_sent: np.ndarray,
    max_n: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorised per-domain (char or word) n-gram statistics.

    Returns ``(pred_totals (S, N), ref_totals (R, N), matches (R, N))`` where ``matches[r, n]``
    is the clipped n-gram intersection of ref ``r`` with ITS sentence's prediction.
    """
    from torchmetrics_tpu_torch.functional.text._ngram import intern_streams, iter_ngram_levels

    n_pred = len(pred_streams)
    n_ref = len(ref_streams)
    pred_totals = np.zeros((n_pred, max_n), np.float32)
    ref_totals = np.zeros((n_ref, max_n), np.float32)
    matches = np.zeros((n_ref, max_n), np.float32)
    if max_n == 0:
        return pred_totals, ref_totals, matches

    ids_flat, stream_of, vocab = intern_streams(pred_streams + ref_streams)
    for n, codes, valid in iter_ngram_levels(ids_flat, stream_of, vocab, max_n):
        sel = valid
        if not sel.any():
            continue
        streams = stream_of[sel]
        n_codes = int(codes[sel].max()) + 1
        is_pred = streams < n_pred
        # totals: number of n-gram positions per stream
        pred_totals[:, n - 1] = np.bincount(streams[is_pred], minlength=n_pred)[:n_pred]
        ref_totals[:, n - 1] = np.bincount(streams[~is_pred] - n_pred, minlength=n_ref)[:n_ref]
        # per-(pred sentence, gram) counts, keys sorted by np.unique
        pkeys, pcounts = np.unique(streams[is_pred] * n_codes + codes[sel][is_pred], return_counts=True)
        # per-(ref, gram) counts
        rstreams = streams[~is_pred] - n_pred
        rk, rc = np.unique(rstreams * n_codes + codes[sel][~is_pred], return_counts=True)
        r_of = rk // n_codes
        gram = rk % n_codes
        # look up each ref gram in its sentence's prediction counts
        lookup = ref_sent[r_of] * n_codes + gram
        pos = np.searchsorted(pkeys, lookup)
        pos_c = np.minimum(pos, len(pkeys) - 1) if len(pkeys) else np.zeros_like(pos)
        hit = (len(pkeys) > 0) & (pkeys[pos_c] == lookup) if len(pkeys) else np.zeros_like(pos, bool)
        clipped = np.where(hit, np.minimum(rc, pcounts[pos_c] if len(pkeys) else 0), 0)
        np.add.at(matches[:, n - 1], r_of, clipped)
    return pred_totals, ref_totals, matches


def _fscore_np(m_char, m_word, h_char, h_word, r_char, r_word, n_order: float, beta: float) -> np.ndarray:
    """Vectorised numpy twin of ``_calculate_fscore`` over leading batch dims."""

    def _f(match, hyp, ref):
        precision = np.where(hyp > 0, match / np.maximum(hyp, 1e-38), 0.0).astype(np.float32)
        recall = np.where(ref > 0, match / np.maximum(ref, 1e-38), 0.0).astype(np.float32)
        denominator = np.maximum(beta**2 * precision + recall, _EPS_SMOOTHING).astype(np.float32)
        return ((1 + beta**2) * precision * recall / denominator).astype(np.float32)

    char_f = _f(m_char, h_char, r_char).sum(axis=-1)
    word_f = _f(m_word, h_word, r_word).sum(axis=-1)
    return ((char_f + word_f) / n_order).astype(np.float32)


def _chrf_score_update_batched(
    preds: Union[str, Sequence[str]],
    target: Union[Sequence[str], Sequence[Sequence[str]]],
    totals: Dict[str, np.ndarray],
    n_char_order: int,
    n_word_order: int,
    n_order: float,
    beta: float,
    lowercase: bool,
    whitespace: bool,
    sentence_chrf_score: Optional[List[float]] = None,
) -> Optional[List[float]]:
    """Vectorised twin of ``_chrf_score_update``: intern → dense-code counting → per-(sentence,
    ref) clipped matches → best-reference selection, all as numpy array passes (fuzz-pinned
    equal to the loop implementation in the text tests)."""
    if isinstance(preds, str):
        preds = [preds]
    target_corpus = [[t] if isinstance(t, str) else t for t in target]
    if len(preds) != len(target_corpus):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target_corpus)}")
    n_sent = len(preds)

    def _prep(s: str) -> str:
        return s.lower() if lowercase else s

    # the whitespace flag only affects the char stream; words always go through the
    # punctuation-separating tokenizer (same as _get_n_grams_counts_and_total_ngrams)
    pred_chars = [_get_characters(_prep(p), whitespace) for p in preds]
    pred_words = [_get_words_and_punctuation(_prep(p)) for p in preds]
    refs_flat: List[str] = [r for refs in target_corpus for r in refs]
    ref_sent = np.asarray([i for i, refs in enumerate(target_corpus) for _ in refs], np.int64)
    ref_chars = [_get_characters(_prep(r), whitespace) for r in refs_flat]
    ref_words = [_get_words_and_punctuation(_prep(r)) for r in refs_flat]

    pc_tot, rc_tot, mc = _domain_stats_batched(pred_chars, ref_chars, ref_sent, n_char_order)
    pw_tot, rw_tot, mw = _domain_stats_batched(pred_words, ref_words, ref_sent, n_word_order)

    totals["preds_char"] += pc_tot.sum(axis=0)
    totals["preds_word"] += pw_tot.sum(axis=0)

    if len(refs_flat):
        f = _fscore_np(
            mc, mw, pc_tot[ref_sent], pw_tot[ref_sent], rc_tot, rw_tot, n_order, beta
        )  # (R,)
        # first ref with the max f per sentence (strictly-greater update rule of the loop)
        ref_order = np.arange(len(refs_flat))
        order = np.lexsort((ref_order, -f, ref_sent))
        first = order[np.flatnonzero(np.r_[True, ref_sent[order][1:] != ref_sent[order][:-1]])]
        best_sent = ref_sent[first]
    else:
        first = np.zeros(0, np.int64)
        best_sent = np.zeros(0, np.int64)

    best_f = np.zeros(n_sent, np.float32)
    if len(first):
        # zero-F sentences contribute no reference stats (strict-greater rule, see loop twin)
        contributing = first[f[first] > 0]
        totals["matching_char"] += mc[contributing].sum(axis=0)
        totals["matching_word"] += mw[contributing].sum(axis=0)
        totals["target_char"] += rc_tot[contributing].sum(axis=0)
        totals["target_word"] += rw_tot[contributing].sum(axis=0)
        best_f[best_sent] = f[first]
    if sentence_chrf_score is not None:
        sentence_chrf_score.extend(float(x) for x in best_f)
    return sentence_chrf_score
