"""BLEU score (counterpart of ``torchmetrics_tpu/functional/text/bleu.py``, reference
``functional/text/bleu.py``).

The state is the reference's (``text/bleu.py:91-94``): ``(n_gram,)`` numerator and denominator count
vectors and two length scalars. Counting n-grams is host string work, as in JAX (the vectorised
``_bleu_score_update_batched``, numpy only, copied); everything after it is tensor code on the device.
The compute's ``jnp.maximum(x, 1e-38)`` guards are :func:`~torchmetrics_tpu_torch.utils.compute._flushed_floor`,
so an empty denominator divides 0/0 as XLA does; the final ``where`` masks it either way.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import resolve_device
from torchmetrics_tpu_torch.utils.compute import _flushed_floor


def _count_ngram(ngram_input_list: Sequence[str], n_gram: int) -> Counter:
    """Counter of 1..n grams (reference ``bleu.py:24-45``)."""
    ngram_counter: Counter = Counter()
    for i in range(1, n_gram + 1):
        for j in range(len(ngram_input_list) - i + 1):
            ngram_counter[tuple(ngram_input_list[j : i + j])] += 1
    return ngram_counter


def _tokenize_fn(sentence: str) -> Sequence[str]:
    """Whitespace tokenizer (reference ``bleu.py:48-58``)."""
    return sentence.split()


def _bleu_score_update(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    numerator: np.ndarray,
    denominator: np.ndarray,
    preds_len: float,
    target_len: float,
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[float, float]:
    """Accumulate clipped n-gram counts into host numpy buffers (reference ``bleu.py:60-105``).

    Mutates ``numerator``/``denominator`` in place and returns updated lengths.
    """
    target_tok = [[tokenizer(line) if line else [] for line in t] for t in target]
    preds_tok = [tokenizer(line) if line else [] for line in preds]
    for pred, targets in zip(preds_tok, target_tok):
        preds_len += len(pred)
        target_len_list = [len(tgt) for tgt in targets]
        target_len_diff = [abs(len(pred) - x) for x in target_len_list]
        target_len += target_len_list[target_len_diff.index(min(target_len_diff))]
        preds_counter = _count_ngram(pred, n_gram)
        target_counter: Counter = Counter()
        for tgt in targets:
            target_counter |= _count_ngram(tgt, n_gram)
        clipped = preds_counter & target_counter
        for key in clipped:
            numerator[len(key) - 1] += clipped[key]
        for key in preds_counter:
            denominator[len(key) - 1] += preds_counter[key]
    return preds_len, target_len


def _bleu_score_compute(
    preds_len: Tensor,
    target_len: Tensor,
    numerator: Tensor,
    denominator: Tensor,
    n_gram: int,
    weights: Sequence[float],
    smooth: bool,
) -> Tensor:
    """BLEU from the counts (``bleu.py:68``), with no host read."""
    numerator = numerator.to(torch.float32)
    denominator = denominator.to(torch.float32)
    preds_len = preds_len.to(torch.float32)
    target_len = target_len.to(torch.float32)
    if smooth:
        precision_scores = torch.cat([numerator[:1] / _flushed_floor(denominator[:1]),
                                      ((numerator + 1.0) / (denominator + 1.0))[1:]])
    else:
        precision_scores = numerator / _flushed_floor(denominator)
    w = torch.tensor(list(weights), dtype=torch.float32, device=numerator.device)
    geometric_mean = torch.exp(torch.sum(w * torch.log(_flushed_floor(precision_scores))))
    brevity_penalty = torch.where(preds_len > target_len, 1.0, torch.exp(1 - target_len / _flushed_floor(preds_len)))
    return torch.where(torch.min(numerator) == 0.0, 0.0, brevity_penalty * geometric_mean)


def bleu_score(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    n_gram: int = 4,
    smooth: bool = False,
    weights: Optional[Sequence[float]] = None,
    device: Union[str, torch.device, None] = None,
) -> Tensor:
    """BLEU of translated text against one or more references (``bleu.py:98``), on ``device`` (CUDA
    unless named).

    Example:
        >>> from torchmetrics_tpu_torch.functional import bleu_score
        >>> preds = ['the cat is on the mat']
        >>> target = [['there is a cat on the mat']]
        >>> print(f"{float(bleu_score(preds, target, device='cpu')):.4f}")
        0.0000
    """
    device = resolve_device(device)
    preds_ = [preds] if isinstance(preds, str) else preds
    target_ = [[tgt] if isinstance(tgt, str) else tgt for tgt in target]
    if len(preds_) != len(target_):
        raise ValueError(f"Corpus has different size {len(preds_)} != {len(target_)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram
    numerator = np.zeros(n_gram)
    denominator = np.zeros(n_gram)
    preds_len, target_len = _bleu_score_update_batched(preds_, target_, numerator, denominator, 0.0, 0.0, n_gram)
    return _bleu_score_compute(*_on_device(preds_len, target_len, numerator, denominator, device), n_gram, weights,
                               smooth)


def _on_device(preds_len: float, target_len: float, numerator: np.ndarray, denominator: np.ndarray,
               device: torch.device) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The host counts as float32 tensors on ``device``, as JAX's ``jnp.asarray`` makes them."""
    packed = torch.from_numpy(np.concatenate([[preds_len, target_len], numerator, denominator]).astype(np.float32))
    packed = packed.to(device)
    n = len(numerator)
    return packed[0], packed[1], packed[2:2 + n], packed[2 + n:]


def _bleu_score_update_batched(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    numerator: np.ndarray,
    denominator: np.ndarray,
    preds_len: float,
    target_len: float,
    n_gram: int = 4,
    tokenizer: Callable[[str], Sequence[str]] = _tokenize_fn,
) -> Tuple[float, float]:
    """Vectorised corpus n-gram counting: intern tokens -> compacted rolling codes ->
    np.unique group counts, instead of one Python ``Counter`` pass per sentence (semantics of
    ``_bleu_score_update`` preserved exactly; fuzz-pinned against it in the text tests).

    Mutates ``numerator``/``denominator`` in place and returns updated lengths.
    """
    preds_tok = [tokenizer(line) if line else [] for line in preds]
    target_tok = [[tokenizer(line) if line else [] for line in t] for t in target]

    # sentence lengths and closest-reference lengths (first minimum wins, like list.index)
    for pred, refs in zip(preds_tok, target_tok):
        preds_len += len(pred)
        diffs = [abs(len(pred) - len(r)) for r in refs]
        target_len += len(refs[diffs.index(min(diffs))])

    # flatten pred and ref streams with owner ids (shared machinery with chrF)
    from torchmetrics_tpu_torch.functional.text._ngram import intern_streams, iter_ngram_levels

    all_streams = preds_tok + [r for refs in target_tok for r in refs]
    n_pred = len(preds_tok)
    stream_sent = np.asarray(
        list(range(n_pred)) + [i for i, refs in enumerate(target_tok) for _ in refs], np.int64
    )
    is_pred = np.asarray([True] * n_pred + [False] * (len(all_streams) - n_pred))
    ids_flat, stream_of, vocab_size = intern_streams(all_streams)

    for n, codes, valid in iter_ngram_levels(ids_flat, stream_of, vocab_size, n_gram):
        sel = valid
        if not sel.any():
            continue
        # compact the (sentence, gram) keys before any further composition: keeps every
        # subsequent key bounded by the number of DISTINCT pairs, never by products of ranges
        n_codes = int(codes[sel].max()) + 1
        sent = stream_sent[stream_of[sel]]
        _, key = np.unique(sent * n_codes + codes[sel], return_inverse=True)
        pred_mask = is_pred[stream_of[sel]]
        # per-(sentence, gram) pred counts
        pk, pc = np.unique(key[pred_mask], return_counts=True)
        denominator[n - 1] += int(pc.sum())
        if pk.size == 0:
            continue
        # per-(sentence, ref, gram) counts -> max over refs per (sentence, gram). key is dense
        # (< total positions) so composing with the stream index stays far below int64 range.
        ref_stream = stream_of[sel][~pred_mask]
        rkey = key[~pred_mask]
        if rkey.size == 0:
            # no reference holds an n-gram of this order: nothing clips. The JAX package's
            # ``np.maximum.reduceat`` raises IndexError on the empty set here; the loop twin above and
            # the reference count 0 (ROADMAP.md, "Differences the port keeps on purpose")
            continue
        rk, rc = np.unique(rkey * (len(all_streams) + 1) + ref_stream, return_counts=True)
        rk_gram = rk // (len(all_streams) + 1)
        boundaries = np.flatnonzero(np.r_[True, rk_gram[1:] != rk_gram[:-1]])
        ref_max = np.maximum.reduceat(rc, boundaries)
        ref_gram = rk_gram[boundaries]
        # clipped counts: min(pred count, ref max) over grams present in both
        common, pi, ri = np.intersect1d(pk, ref_gram, assume_unique=True, return_indices=True)
        numerator[n - 1] += int(np.minimum(pc[pi], ref_max[ri]).sum())
    return preds_len, target_len
