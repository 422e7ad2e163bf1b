"""ROUGE-N, ROUGE-L and ROUGE-Lsum (counterpart of ``torchmetrics_tpu/functional/text/rouge.py``,
reference ``functional/text/rouge.py``).

Host string work by nature (tokenisation, LCS over token sequences), copied from the JAX package: the
LCS tables are a row-wise numpy DP. The per-sentence score triples go to the device.

The sentence split of ``rougeLsum`` (``_split_sentence``) never downloads and never probes the
network. It uses nltk's ``punkt`` where nltk is installed and the model is on disk, and otherwise
JAX's regex split on sentence-final punctuation (``rouge.py:25-54``). Where nltk itself is missing
the JAX package raises ``ImportError``; the port takes the same regex split (``ROADMAP.md``,
"Differences the port keeps on purpose"). ``use_stemmer=True`` needs nltk's Porter stemmer and
raises without nltk, as in JAX.
"""
from __future__ import annotations

import re
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.metric import resolve_device

ALLOWED_ROUGE_KEYS: Dict[str, Union[int, str]] = {
    "rouge1": 1, "rouge2": 2, "rouge3": 3, "rouge4": 4, "rouge5": 5, "rouge6": 6,
    "rouge7": 7, "rouge8": 8, "rouge9": 9, "rougeL": "L", "rougeLsum": "Lsum",
}
ALLOWED_ACCUMULATE_VALUES = ("avg", "best")

#: whether nltk's ``punkt`` model is on disk; None until the first split looks
_PUNKT_AVAILABLE: Optional[bool] = None


def _punkt_available() -> bool:
    """nltk is installed and its ``punkt`` model is on disk: looked up once, never downloaded."""
    global _PUNKT_AVAILABLE
    if _PUNKT_AVAILABLE is None:
        try:
            import nltk

            nltk.data.find("tokenizers/punkt")
            _PUNKT_AVAILABLE = True
        except (ImportError, LookupError):
            _PUNKT_AVAILABLE = False
    return _PUNKT_AVAILABLE


def _split_sentence(x: str) -> Sequence[str]:
    """The sentences of ``x`` for ``rougeLsum``: nltk's ``sent_tokenize`` where ``punkt`` is on disk,
    else JAX's regex split on sentence-final punctuation (``rouge.py:25-54``)."""
    x = re.sub("<n>", "", x)  # the pegasus newline token, stripped as in JAX (the reference drops the result)
    if _punkt_available():
        import nltk

        return nltk.sent_tokenize(x)
    return [s for s in re.split(r"(?<=[.!?])\s+", x.strip()) if s]


def _compute_metrics(hits_or_lcs: int, pred_len: int, target_len: int) -> Dict[str, float]:
    """precision/recall/F1 from a hit count (reference ``rouge.py:74-93``)."""
    precision = hits_or_lcs / pred_len
    recall = hits_or_lcs / target_len
    if precision == recall == 0.0:
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    fmeasure = 2 * precision * recall / (precision + recall)
    return {"precision": precision, "recall": recall, "fmeasure": fmeasure}


def _lcs_table(pred: Sequence[str], target: Sequence[str]) -> np.ndarray:
    """LCS DP table via rowwise numpy recurrence; shape (len(target)+1, len(pred)+1).

    Row identity: with ``cand[j] = prev[j-1]+1`` on match else ``prev[j]``, the standard LCS
    recurrence collapses to a prefix-max of ``cand`` (adjacent table cells differ by ≤ 1, so the
    match branch always dominates its neighbours) — one vectorised pass per target token.
    """
    vocab: Dict[str, int] = {}
    pred_ids = np.asarray([vocab.setdefault(t, len(vocab)) for t in pred], np.int64)
    table = np.zeros((len(target) + 1, len(pred) + 1), np.int32)
    for i, tgt_tok in enumerate(target, start=1):
        match = pred_ids == vocab.get(tgt_tok, -1)
        prev = table[i - 1]
        cand = np.where(match, prev[:-1] + 1, prev[1:])
        table[i, 1:] = np.maximum.accumulate(cand)
    return table


def _lcs_len(pred: Sequence[str], target: Sequence[str]) -> int:
    return int(_lcs_table(pred, target)[-1, -1])


def _backtracked_lcs(table: np.ndarray, pred: Sequence[str], target: Sequence[str]) -> List[int]:
    """Indices into ``target`` of one LCS (reference ``rouge.py:119-141``)."""
    i, j = len(pred), len(target)
    out: List[int] = []
    while i > 0 and j > 0:
        if pred[i - 1] == target[j - 1]:
            out.insert(0, j - 1)
            i -= 1
            j -= 1
        elif table[j][i - 1] > table[j - 1][i]:
            i -= 1
        else:
            j -= 1
    return out


def _union_lcs(pred_sentences: Sequence[Sequence[str]], target_sentence: Sequence[str]) -> List[str]:
    """Union of LCS indices of a target sentence vs every pred sentence (reference ``rouge.py:144-163``)."""
    indices: set = set()
    for pred in pred_sentences:
        table = _lcs_table(pred, target_sentence)  # (len(target)+1, len(pred)+1)
        indices.update(_backtracked_lcs(table, pred, target_sentence))
    return [target_sentence[i] for i in sorted(indices)]


def _normalize_and_tokenize_text(
    text: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Sequence[str]:
    """Lowercase, strip non-alphanumerics, optional Porter stemming (reference ``rouge.py:166-200``)."""
    text = normalizer(text) if callable(normalizer) else re.sub(r"[^a-z0-9]+", " ", text.lower())
    tokens = tokenizer(text) if callable(tokenizer) else re.split(r"\s+", text)
    if stemmer:
        tokens = [stemmer.stem(x) if len(x) > 3 else x for x in tokens]
    return [x for x in tokens if (isinstance(x, str) and len(x) > 0)]


def _rouge_n_score(pred: Sequence[str], target: Sequence[str], n_gram: int) -> Dict[str, float]:
    """Reference ``rouge.py:203-227``."""

    def _create_ngrams(tokens: Sequence[str], n: int) -> Counter:
        c: Counter = Counter()
        for ngram in (tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)):
            c[ngram] += 1
        return c

    pred_ngrams, target_ngrams = _create_ngrams(pred, n_gram), _create_ngrams(target, n_gram)
    pred_len, target_len = sum(pred_ngrams.values()), sum(target_ngrams.values())
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    hits = sum(min(pred_ngrams[w], target_ngrams[w]) for w in set(pred_ngrams))
    return _compute_metrics(hits, max(pred_len, 1), max(target_len, 1))


def _rouge_l_score(pred: Sequence[str], target: Sequence[str]) -> Dict[str, float]:
    """Reference ``rouge.py:230-243``."""
    if 0 in (len(pred), len(target)):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    return _compute_metrics(_lcs_len(pred, target), len(pred), len(target))


def _rouge_lsum_score(pred: Sequence[Sequence[str]], target: Sequence[Sequence[str]]) -> Dict[str, float]:
    """Reference ``rouge.py:246-285``."""
    pred_len = sum(map(len, pred))
    target_len = sum(map(len, target))
    if 0 in (pred_len, target_len):
        return {"precision": 0.0, "recall": 0.0, "fmeasure": 0.0}
    pred_counts: Counter = Counter()
    for s in pred:
        pred_counts.update(s)
    target_counts: Counter = Counter()
    for s in target:
        target_counts.update(s)
    hits = 0
    for tgt in target:
        for token in _union_lcs(pred, tgt):
            if pred_counts[token] > 0 and target_counts[token] > 0:
                hits += 1
                pred_counts[token] -= 1
                target_counts[token] -= 1
    return _compute_metrics(hits, pred_len, target_len)


def _rouge_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    rouge_keys_values: List[Union[int, str]],
    accumulate: str,
    stemmer: Optional[Any] = None,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
) -> Dict[Union[int, str], List[Dict[str, float]]]:
    """Per-sentence score triples for every rouge key (reference ``rouge.py:288-400``)."""
    results: Dict[Union[int, str], List[Dict[str, float]]] = {k: [] for k in rouge_keys_values}
    for pred_raw, target_raw in zip(preds, target):
        pred = _normalize_and_tokenize_text(pred_raw, stemmer, normalizer, tokenizer)
        pred_lsum = None
        if "Lsum" in rouge_keys_values:
            pred_lsum = [
                _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer)
                for s in _split_sentence(pred_raw)
            ]
        per_ref: List[Dict[Union[int, str], Dict[str, float]]] = []
        for target_raw_inner in target_raw:
            tgt = _normalize_and_tokenize_text(target_raw_inner, stemmer, normalizer, tokenizer)
            scores: Dict[Union[int, str], Dict[str, float]] = {}
            for key in rouge_keys_values:
                if isinstance(key, int):
                    scores[key] = _rouge_n_score(pred, tgt, key)
                elif key == "L":
                    scores[key] = _rouge_l_score(pred, tgt)
                else:  # Lsum
                    tgt_lsum = [
                        _normalize_and_tokenize_text(s, stemmer, normalizer, tokenizer)
                        for s in _split_sentence(target_raw_inner)
                    ]
                    scores[key] = _rouge_lsum_score(pred_lsum, tgt_lsum)
            per_ref.append(scores)
        if accumulate == "best":
            first_key = rouge_keys_values[0]
            best_idx = int(np.argmax([r[first_key]["fmeasure"] for r in per_ref]))
            for key in rouge_keys_values:
                results[key].append(per_ref[best_idx][key])
        else:  # avg
            for key in rouge_keys_values:
                avg = {
                    typ: float(np.mean([r[key][typ] for r in per_ref]))
                    for typ in ("precision", "recall", "fmeasure")
                }
                results[key].append(avg)
    return results


def _stemmer_or_none(use_stemmer: bool):
    if not use_stemmer:
        return None
    import nltk.stem.porter

    return nltk.stem.porter.PorterStemmer()


def _normalize_target(preds: Union[str, Sequence[str]], target: Any) -> Tuple[List[str], List[List[str]]]:
    """The nesting rule of JAX's ``rouge_score`` (``rouge.py:262-267``): a flat sequence of target
    strings is one multi-reference set when there is a single prediction, one reference each otherwise."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [[target]]
    elif target and all(isinstance(t, str) for t in target):
        target = [[t] for t in target] if len(preds) > 1 else [list(target)]
    return list(preds), target


def _check_rouge_args(rouge_keys: Any, accumulate: str) -> Tuple[str, ...]:
    if not isinstance(rouge_keys, tuple):
        rouge_keys = (rouge_keys,)
    for key in rouge_keys:
        if key not in ALLOWED_ROUGE_KEYS:
            raise ValueError(f"Got unknown rouge key {key}. Expected to be one of {list(ALLOWED_ROUGE_KEYS.keys())}")
    if accumulate not in ALLOWED_ACCUMULATE_VALUES:
        raise ValueError(
            f"Got unknown accumulate value {accumulate}. Expected to be one of {ALLOWED_ACCUMULATE_VALUES}"
        )
    return rouge_keys


def rouge_score(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    accumulate: str = "best",
    use_stemmer: bool = False,
    normalizer: Optional[Callable[[str], str]] = None,
    tokenizer: Optional[Callable[[str], Sequence[str]]] = None,
    rouge_keys: Union[str, Tuple[str, ...]] = ("rouge1", "rouge2", "rougeL", "rougeLsum"),
    device: Union[str, torch.device, None] = None,
):
    """ROUGE-N, ROUGE-L and ROUGE-Lsum (``rouge.py:232``), on ``device`` (CUDA unless named): each
    score the float64 numpy mean over the sentences, as in JAX.

    Example:
        >>> from torchmetrics_tpu_torch.functional import rouge_score
        >>> score = rouge_score('the cat sat', 'the cat sat down', rouge_keys='rouge1', device='cpu')
        >>> print(f"{float(score['rouge1_fmeasure']):.4f}")
        0.8571
    """
    rouge_keys = _check_rouge_args(rouge_keys, accumulate)
    device = resolve_device(device)
    key_values = [ALLOWED_ROUGE_KEYS[k] for k in rouge_keys]
    preds, target = _normalize_target(preds, target)
    stemmer = _stemmer_or_none(use_stemmer)
    sentence_results = _rouge_score_update(preds, target, key_values, accumulate, stemmer, normalizer, tokenizer)
    means = [float(np.mean([s[typ] for s in sentence_results[key_val]])) if sentence_results[key_val] else 0.0
             for key_val in key_values for typ in ("precision", "recall", "fmeasure")]
    values = torch.tensor(means, dtype=torch.float32, device=device)
    names = [f"{key_name}_{typ}" for key_name in rouge_keys for typ in ("precision", "recall", "fmeasure")]
    return dict(zip(names, values.unbind()))
