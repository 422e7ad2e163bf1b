"""Translation edit rate (counterpart of ``torchmetrics_tpu/functional/text/ter.py``, reference
``functional/text/ter.py``).

Tercom's algorithm: greedy phrase shifts that lower the word-level Levenshtein distance, with its
candidate ranking and limits (shift size 10, distance 50, 1,000 candidates), and the tercom text
normalisation behind an ``lru_cache``. It is sequential host string work, copied from the JAX package
as it is (``ter.py:24-331``: the full-matrix numpy DP with its trace, the shift search, the
flag-gated normalisation table); only the two accumulators live on the device.
"""
from __future__ import annotations

import re
from functools import lru_cache, partial
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import resolve_device

_MAX_SHIFT_SIZE = 10
_MAX_SHIFT_DIST = 50
_MAX_SHIFT_CANDIDATES = 1000

# ops for the trace; preference order on cost ties is substitution/match, then delete, then
# insert (the flipped-trace convention of tercom/sacrebleu)
_OP_NOTHING, _OP_SUBSTITUTE, _OP_DELETE, _OP_INSERT = 0, 1, 2, 3

# ---------------------------------------------------------------------------
# Tercom text normalisation. The regex constants below are tercom/sacrebleu's published
# ``tokenizer_ter`` tables; the representation is a flag-gated pipeline: each stage is
# (gate over the three boolean flags, pad-with-spaces?, [(pattern, replacement), ...]).
# ---------------------------------------------------------------------------
_ASIAN_PUNCT = r"([、。〈-】〔-〟｡-･・])"
_FULLWIDTH_PUNCT = r"([．，？：；！＂（）])"

_WESTERN_NORMALIZE = [
    # newline stitching + XML entity unescaping
    (r"\n-", ""), (r"\n", " "),
    (r"&quot;", '"'), (r"&amp;", "&"), (r"&lt;", "<"), (r"&gt;", ">"),
    # isolate symbol chars, possessive 's, punctuation not inside numbers, number-dash
    (r"([{-~[-` -&(-+:-@/])", r" \1 "),
    (r"'s ", r" 's "), (r"'s$", r" 's"),
    (r"([^0-9])([\.,])", r"\1 \2 "), (r"([\.,])([^0-9])", r" \1 \2"),
    (r"([0-9])(-)", r"\1 \2 "),
]
_ASIAN_NORMALIZE = [
    (r"([一-鿿㐀-䶿])", r" \1 "),
    (r"([㇀-㇯⺀-⻿])", r" \1 "),
    (r"([㌀-㏿豈-﫿︰-﹏])", r" \1 "),
    (r"([㈀-㼢])", r" \1 "),
    (r"(^|^[぀-ゟ])([぀-ゟ]+)(?=$|^[぀-ゟ])", r"\1 \2 "),
    (r"(^|^[゠-ヿ])([゠-ヿ]+)(?=$|^[゠-ヿ])", r"\1 \2 "),
    (r"(^|^[ㇰ-ㇿ])([ㇰ-ㇿ]+)(?=$|^[ㇰ-ㇿ])", r"\1 \2 "),
    (_ASIAN_PUNCT, r" \1 "), (_FULLWIDTH_PUNCT, r" \1 "),
]
_WESTERN_STRIP = [(r"[\.,\?:;!\"\(\)]", "")]
_ASIAN_STRIP = [(_ASIAN_PUNCT, ""), (_FULLWIDTH_PUNCT, "")]


def _compile_rules(rules):
    return tuple((re.compile(p), r) for p, r in rules)


# stages gated on (normalize, no_punctuation, asian_support); lowercase is not a regex pass and
# is handled directly in ``_tercom_normalize``. ``pad`` wraps the sentence in single spaces
# first (tercom pads before the western normalisation pass).
_STAGES = (
    (lambda norm, nopunct, asian: norm, True, _compile_rules(_WESTERN_NORMALIZE)),
    (lambda norm, nopunct, asian: norm and asian, False, _compile_rules(_ASIAN_NORMALIZE)),
    (lambda norm, nopunct, asian: nopunct, False, _compile_rules(_WESTERN_STRIP)),
    (lambda norm, nopunct, asian: nopunct and asian, False, _compile_rules(_ASIAN_STRIP)),
)


@lru_cache(maxsize=2**16)
def _tercom_normalize(
    sentence: str, normalize: bool, no_punctuation: bool, lowercase: bool, asian_support: bool
) -> str:
    """Run the enabled normalisation stages and collapse whitespace."""
    if not sentence:
        return ""
    if lowercase:
        sentence = sentence.lower()
    for gate, pad, rules in _STAGES:
        if not gate(normalize, no_punctuation, asian_support):
            continue
        if pad:
            sentence = f" {sentence} "
        for pattern, replacement in rules:
            sentence = pattern.sub(replacement, sentence)
    return " ".join(sentence.split())


def _TercomTokenizer(
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
) -> Callable[[str], str]:
    """Bind normalisation flags into a ``str -> str`` tokenizer (a picklable partial)."""
    return partial(
        _tercom_normalize,
        normalize=normalize,
        no_punctuation=no_punctuation,
        lowercase=lowercase,
        asian_support=asian_support,
    )


def _validate_inputs(
    ref_corpus: Union[Sequence[str], Sequence[Sequence[str]]],
    hypothesis_corpus: Union[str, Sequence[str]],
) -> Tuple[Sequence[Sequence[str]], Sequence[str]]:
    """Normalise corpus nesting (reference ``helper.py:297-326``)."""
    if isinstance(hypothesis_corpus, str):
        hypothesis_corpus = [hypothesis_corpus]
    if all(isinstance(ref, str) for ref in ref_corpus):
        ref_corpus = [ref_corpus] if len(hypothesis_corpus) == 1 else [[ref] for ref in ref_corpus]
    if hypothesis_corpus and all(ref for ref in ref_corpus) and len(ref_corpus) != len(hypothesis_corpus):
        raise ValueError(f"Corpus has different size {len(ref_corpus)} != {len(hypothesis_corpus)}")
    return ref_corpus, hypothesis_corpus


def _levenshtein_with_trace(hyp: List[str], ref: List[str]) -> Tuple[int, List[int]]:
    """Word Levenshtein distance + operation trace (hyp → ref), tercom tie preference."""
    h, r = len(hyp), len(ref)
    dist = np.zeros((h + 1, r + 1), np.int32)
    op = np.zeros((h + 1, r + 1), np.int8)
    dist[0, :] = np.arange(r + 1)
    op[0, 1:] = _OP_INSERT
    dist[1:, 0] = np.arange(1, h + 1)
    op[1:, 0] = _OP_DELETE
    for i in range(1, h + 1):
        sub_cost = dist[i - 1, :-1] + (np.asarray([hyp[i - 1] != w for w in ref]) if r else 0)
        del_cost = dist[i - 1, 1:] + 1
        # insert chain within the row (cost +1 per step, possibly starting at column 0):
        # dist[i, j] = cols[j] + min_{k<=j} (base[k] - cols[k]) — a prefix-min
        base = np.minimum(sub_cost, del_cost)
        cols = np.arange(1, r + 1)
        chain = np.minimum.accumulate(np.concatenate(([dist[i, 0]], base - cols)))
        dist[i, 1:] = chain[1:] + cols
        # record ops with tie preference sub/nothing > delete > insert
        row = dist[i, 1:]
        is_sub = row == sub_cost
        is_del = (row == del_cost) & ~is_sub
        match = np.asarray([hyp[i - 1] == w for w in ref]) if r else np.zeros(0, bool)
        op[i, 1:] = np.where(is_sub, np.where(match, _OP_NOTHING, _OP_SUBSTITUTE),
                             np.where(is_del, _OP_DELETE, _OP_INSERT))
    # backtrace
    trace: List[int] = []
    i, j = h, r
    while i > 0 or j > 0:
        o = int(op[i, j])
        trace.insert(0, o)
        if o in (_OP_NOTHING, _OP_SUBSTITUTE):
            i -= 1
            j -= 1
        elif o == _OP_INSERT:
            j -= 1
        else:
            i -= 1
    return int(dist[h, r]), trace


def _trace_to_alignment(trace: List[int]) -> Tuple[Dict[int, int], List[int], List[int]]:
    """Alignment + error positions from a hyp→ref trace (reference ``helper.py:381-430``)."""
    ref_pos = hyp_pos = -1
    ref_errors: List[int] = []
    hyp_errors: List[int] = []
    alignments: Dict[int, int] = {}
    for o in trace:
        if o == _OP_NOTHING:
            hyp_pos += 1
            ref_pos += 1
            alignments[ref_pos] = hyp_pos
            ref_errors.append(0)
            hyp_errors.append(0)
        elif o == _OP_SUBSTITUTE:
            hyp_pos += 1
            ref_pos += 1
            alignments[ref_pos] = hyp_pos
            ref_errors.append(1)
            hyp_errors.append(1)
        elif o == _OP_INSERT:
            ref_pos += 1
            alignments[ref_pos] = hyp_pos
            ref_errors.append(1)
        else:  # delete
            hyp_pos += 1
            hyp_errors.append(1)
    return alignments, ref_errors, hyp_errors


def _find_shifted_pairs(pred_words: List[str], target_words: List[str]) -> Iterator[Tuple[int, int, int]]:
    """Matching word sub-sequences (reference ``ter.py:205-240``)."""
    for pred_start in range(len(pred_words)):
        for target_start in range(len(target_words)):
            if abs(target_start - pred_start) > _MAX_SHIFT_DIST:
                continue
            for length in range(1, _MAX_SHIFT_SIZE):
                if pred_words[pred_start + length - 1] != target_words[target_start + length - 1]:
                    break
                yield pred_start, target_start, length
                if len(pred_words) == pred_start + length or len(target_words) == target_start + length:
                    break


def _perform_shift(words: List[str], start: int, length: int, target: int) -> List[str]:
    """Reference ``ter.py:282-311``."""
    if target < start:
        return words[:target] + words[start : start + length] + words[target:start] + words[start + length :]
    if target > start + length:
        return words[:start] + words[start + length : target] + words[start : start + length] + words[target:]
    return (
        words[:start] + words[start + length : length + target] + words[start : start + length] + words[length + target :]
    )


def _shift_words(
    pred_words: List[str],
    target_words: List[str],
    checked_candidates: int,
) -> Tuple[int, List[str], int]:
    """One round of Tercom shift search (reference ``ter.py:314-392``)."""
    edit_distance, trace = _levenshtein_with_trace(pred_words, target_words)
    alignments, target_errors, pred_errors = _trace_to_alignment(trace)

    best: Optional[Tuple[int, int, int, int, List[str]]] = None
    for pred_start, target_start, length in _find_shifted_pairs(pred_words, target_words):
        # corner cases: shift must fix an error on both sides and not move within its own span
        if sum(pred_errors[pred_start : pred_start + length]) == 0:
            continue
        if sum(target_errors[target_start : target_start + length]) == 0:
            continue
        if pred_start <= alignments[target_start] < pred_start + length:
            continue

        prev_idx = -1
        for offset in range(-1, length):
            if target_start + offset == -1:
                idx = 0
            elif target_start + offset in alignments:
                idx = alignments[target_start + offset] + 1
            else:
                break
            if idx == prev_idx:
                continue
            prev_idx = idx
            shifted_words = _perform_shift(pred_words, pred_start, length, idx)
            candidate = (
                edit_distance - _levenshtein_with_trace(shifted_words, target_words)[0],
                length,
                -pred_start,
                -idx,
                shifted_words,
            )
            checked_candidates += 1
            if not best or candidate > best:
                best = candidate
        if checked_candidates >= _MAX_SHIFT_CANDIDATES:
            break

    if not best:
        return 0, pred_words, checked_candidates
    best_score, _, _, _, shifted_words = best
    return best_score, shifted_words, checked_candidates


def _translation_edit_rate(pred_words: List[str], target_words: List[str]) -> float:
    """Edits to match one hypothesis with one reference (reference ``ter.py:395-426``)."""
    if len(target_words) == 0:
        return 0.0
    num_shifts = 0
    checked_candidates = 0
    input_words = pred_words
    while True:
        delta, new_input_words, checked_candidates = _shift_words(input_words, target_words, checked_candidates)
        if checked_candidates >= _MAX_SHIFT_CANDIDATES or delta <= 0:
            break
        num_shifts += 1
        input_words = new_input_words
    edit_distance, _ = _levenshtein_with_trace(input_words, target_words)
    return float(num_shifts + edit_distance)


def _compute_sentence_statistics(
    pred_words: List[str], target_words: List[List[str]]
) -> Tuple[float, float]:
    """Best edits over references + average reference length (reference ``ter.py:429-453``)."""
    tgt_lengths = 0.0
    best_num_edits = 2e16
    for tgt_words in target_words:
        num_edits = _translation_edit_rate(tgt_words, pred_words)
        tgt_lengths += len(tgt_words)
        if num_edits < best_num_edits:
            best_num_edits = num_edits
    avg_tgt_len = tgt_lengths / len(target_words)
    return best_num_edits, avg_tgt_len


def _compute_ter_score_from_statistics(num_edits: float, tgt_length: float) -> float:
    """Reference ``ter.py:456-471``."""
    if tgt_length > 0 and num_edits > 0:
        return num_edits / tgt_length
    if tgt_length == 0 and num_edits > 0:
        return 1.0
    return 0.0


def _ter_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    tokenizer: _TercomTokenizer,
    total_num_edits: float,
    total_tgt_length: float,
    sentence_ter: Optional[List[float]] = None,
) -> Tuple[float, float, Optional[List[float]]]:
    """Reference ``ter.py:474-517``."""
    target, preds = _validate_inputs(target, preds)
    for pred, tgt in zip(preds, target):
        tgt_words_ = [tokenizer(_tgt.rstrip()).split() for _tgt in tgt]
        pred_words_ = tokenizer(pred.rstrip()).split()
        num_edits, tgt_length = _compute_sentence_statistics(pred_words_, tgt_words_)
        total_num_edits += num_edits
        total_tgt_length += tgt_length
        if sentence_ter is not None:
            sentence_ter.append(_compute_ter_score_from_statistics(num_edits, tgt_length))
    return total_num_edits, total_tgt_length, sentence_ter


def translation_edit_rate(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    normalize: bool = False,
    no_punctuation: bool = False,
    lowercase: bool = True,
    asian_support: bool = False,
    return_sentence_level_score: bool = False,
    device: Union[str, torch.device, None] = None,
):
    """TER (``ter.py:333``), on ``device`` (CUDA unless named). With sentence scores, a list of
    one-element tensors, as JAX returns them, unless there are none.

    Example:
        >>> from torchmetrics_tpu_torch.functional import translation_edit_rate
        >>> preds = ['the cat is on the mat']
        >>> print(f"{float(translation_edit_rate(preds, [['there is a cat on the mat']], device='cpu')):.4f}")
        0.4286
    """
    for name, val in (
        ("normalize", normalize), ("no_punctuation", no_punctuation),
        ("lowercase", lowercase), ("asian_support", asian_support),
    ):
        if not isinstance(val, bool):
            raise ValueError(f"Expected argument `{name}` to be of type boolean but got {val}.")
    device = resolve_device(device)
    tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
    sentence_ter: Optional[List[float]] = [] if return_sentence_level_score else None
    total_num_edits, total_tgt_length, sentence_ter = _ter_update(
        preds, target, tokenizer, 0.0, 0.0, sentence_ter
    )
    ter = torch.tensor(_compute_ter_score_from_statistics(total_num_edits, total_tgt_length), dtype=torch.float32,
                       device=device)
    if sentence_ter:
        return ter, list(torch.tensor(sentence_ter, dtype=torch.float32, device=device)[:, None])
    return ter
