"""Shared vectorised n-gram machinery for corpus counting metrics (BLEU, chrF): a copy of the JAX
package's ``functional/text/_ngram.py``, which is numpy only.

Tokens are interned to dense int ids once; n-gram identities are built level by level as rolling
codes, compacted with ``np.unique`` at every level so values stay dense (bounded by the number
of positions — no int64 overflow regardless of vocabulary or order). All per-group counting is
``np.unique`` over composed dense keys: vectorised C loops instead of per-sentence Python
``Counter`` passes.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np


def intern_streams(streams: Sequence[Sequence[str]]) -> Tuple[np.ndarray, np.ndarray, int]:
    """Flatten token streams into (ids, owner-stream index, vocab size)."""
    vocab: dict = {}
    ids_list = [
        np.fromiter((vocab.setdefault(t, len(vocab)) for t in toks), np.int64, len(toks))
        for toks in streams
    ]
    ids_flat = np.concatenate(ids_list) if ids_list else np.zeros(0, np.int64)
    lens = np.asarray([len(x) for x in ids_list], np.int64)
    stream_of = np.repeat(np.arange(len(ids_list)), lens)
    return ids_flat, stream_of, max(len(vocab), 1)


def iter_ngram_levels(
    ids_flat: np.ndarray, stream_of: np.ndarray, vocab_size: int, max_n: int
) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
    """Yield ``(n, codes, valid)`` for n = 1..max_n.

    ``codes[i]`` identifies the n-gram starting at position ``i`` (dense ids, comparable only
    within a level); ``valid[i]`` marks windows that fit inside their stream.
    """
    n_tokens = len(ids_flat)
    codes = ids_flat.copy()
    for n in range(1, max_n + 1):
        if n_tokens < n:
            break
        if n > 1:
            valid = np.zeros(n_tokens, bool)
            valid[: n_tokens - (n - 1)] = stream_of[: n_tokens - (n - 1)] == stream_of[n - 1 :]
            raw = np.where(valid, codes * vocab_size, 0)
            raw[: n_tokens - (n - 1)] += np.where(
                valid[: n_tokens - (n - 1)], ids_flat[n - 1 :] + 1, 0
            )
            _, codes = np.unique(raw, return_inverse=True)
        else:
            valid = np.ones(n_tokens, bool)
        yield n, codes, valid
