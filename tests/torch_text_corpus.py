"""Seeded stand-in text for the text tests (``tests/test_torch_text*.py``): short sentences over a small
vocabulary that holds what the tokenizers treat apart (punctuation at word edges, numbers with
separators, XML entities, abbreviations, accented and CJK characters, upper case), with empty strings
among them, and hypotheses made from references by seeded word edits and one phrase move."""
from __future__ import annotations

from typing import List

import numpy as np

WORDS = ["the", "cat", "sat", "on", "a", "mat", "dog", "ran", "Hello", "world", "it's", "don't", "U.S.", "3.14",
         "e.g.", "1,000", "well-known", "&amp;", "&quot;x&quot;", "naïve", "café", "日本語", "中文", "。", "，", "!", "?",
         "(x)", "--", "cat.", "mat,", "Dr.", "an", "The", "sat!", "5-6", "x/y", "ÆØ", "ﾃｽﾄ"]


def sentences(seed: int, n: int, max_words: int = 12, empty_every: int = 0) -> List[str]:
    """``n`` sentences of 0 to ``max_words`` words; every ``empty_every``-th one empty when set."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        k = 0 if empty_every and i % empty_every == empty_every - 1 else rng.randint(1, max_words + 1)
        out.append(" ".join(rng.choice(WORDS, k)))
    return out


def hypotheses(refs: List[str], seed: int, p_edit: float = 0.25) -> List[str]:
    """Each reference with seeded substitutions, deletions and insertions, and one phrase moved."""
    rng = np.random.RandomState(seed)
    out = []
    for ref in refs:
        words = []
        for w in ref.split():
            r = rng.rand()
            if r < p_edit / 3:
                words.append(str(rng.choice(WORDS)))
            elif r < 2 * p_edit / 3:
                continue
            elif r < p_edit:
                words += [w, str(rng.choice(WORDS))]
            else:
                words.append(w)
        if len(words) > 3:
            i = rng.randint(0, len(words) - 2)
            phrase, rest = words[i:i + 2], words[:i] + words[i + 2:]
            j = rng.randint(0, len(rest) + 1)
            words = rest[:j] + phrase + rest[j:]
        out.append(" ".join(words))
    return out
