"""SacreBLEU (counterpart of ``torchmetrics_tpu/functional/text/sacre_bleu.py``, reference
``functional/text/sacre_bleu.py``).

BLEU's count-vector state, with the sacrebleu tokenizers the JAX package implements (``none``,
``13a``, ``zh``, ``intl``, ``char``; ``_SacreBLEUTokenizer``, copied). ``intl`` needs the ``regex``
package and raises without it, as in JAX (``sacre_bleu.py:60-70,133-135``); ``ja-mecab``,
``ko-mecab`` and ``flores101/200`` need external segmenters and raise (``:20``).
"""
from __future__ import annotations

import re
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.bleu import _bleu_score_compute, _bleu_score_update_batched, _on_device
from torchmetrics_tpu_torch.metric import resolve_device

AVAILABLE_TOKENIZERS = ("none", "13a", "zh", "intl", "char")
_UNSUPPORTED_TOKENIZERS = ("ja-mecab", "ko-mecab", "flores101", "flores200")

# CJK codepoint ranges used by the `zh` tokenizer (sacrebleu convention; reference
# ``sacre_bleu.py:63-87``)
_UCODE_RANGES = (
    ("\u3400", "\u4db5"),  # CJK Unified Ideographs Extension A
    ("\u4e00", "\u9fa5"),  # CJK Unified Ideographs
    ("\u9fa6", "\u9fbb"),
    ("\uf900", "\ufa2d"),  # CJK Compatibility Ideographs
    ("\ufa30", "\ufa6a"),
    ("\ufa70", "\ufad9"),
    ("\U00020000", "\U0002a6d6"),  # CJK Unified Ideographs Extension B
    ("\U0002f800", "\U0002fa1d"),  # CJK Compatibility Supplement
    ("\uff00", "\uffef"),  # full-width ASCII / half-width kana / Korean alphabet
    ("\u2e80", "\u2eff"),  # CJK radicals supplement
    ("\u3000", "\u303f"),  # CJK punctuation
    ("\u31c0", "\u31ef"),  # CJK stroke
    ("\u2f00", "\u2fdf"),  # Kangxi radicals
    ("\u2ff0", "\u2fff"),  # Chinese character structure
    ("\u3100", "\u312f"),  # phonetic symbols
    ("\u31a0", "\u31bf"),
    ("\ufe10", "\ufe1f"),
    ("\ufe30", "\ufe4f"),
    ("\u2600", "\u26ff"),
    ("\u2700", "\u27bf"),
    ("\u3200", "\u32ff"),
    ("\u3300", "\u33ff"),
)


class _SacreBLEUTokenizer:
    """Sacrebleu-style tokenizers (reference ``sacre_bleu.py:98``)."""

    _REGEX = (
        (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
        (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
        (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
        (re.compile(r"([0-9])(-)"), r"\1 \2 "),
    )

    try:
        import regex

        _INT_REGEX = (
            (regex.compile(r"(\P{N})(\p{P})"), r"\1 \2 "),
            (regex.compile(r"(\p{P})(\P{N})"), r" \1 \2"),
            (regex.compile(r"(\p{S})"), r" \1 "),
        )
        _REGEX_AVAILABLE = True
    except ImportError:  # pragma: no cover
        _REGEX_AVAILABLE = False

    _TOKENIZE_FN = {
        "none": "_tokenize_base",
        "13a": "_tokenize_13a",
        "zh": "_tokenize_zh",
        "intl": "_tokenize_international",
        "char": "_tokenize_char",
    }

    def __init__(self, tokenize: str, lowercase: bool = False) -> None:
        self._check_tokenizers_validity(tokenize)
        self.tokenize_fn = getattr(self, self._TOKENIZE_FN[tokenize])
        self.lowercase = lowercase

    def __call__(self, line: str) -> Sequence[str]:
        tokenized_line = self.tokenize_fn(line)
        return self._lower(tokenized_line, self.lowercase).split()

    @classmethod
    def tokenize(cls, line: str, tokenize: str, lowercase: bool = False) -> Sequence[str]:
        cls._check_tokenizers_validity(tokenize)
        tokenized_line = getattr(cls, cls._TOKENIZE_FN[tokenize])(line)
        return cls._lower(tokenized_line, lowercase).split()

    @classmethod
    def _tokenize_regex(cls, line: str) -> str:
        for _re, repl in cls._REGEX:
            line = _re.sub(repl, line)
        return " ".join(line.split())

    @staticmethod
    def _is_chinese_char(uchar: str) -> bool:
        return any(start <= uchar <= end for start, end in _UCODE_RANGES)

    @classmethod
    def _tokenize_base(cls, line: str) -> str:
        return line

    @classmethod
    def _tokenize_13a(cls, line: str) -> str:
        line = line.replace("<skipped>", "")
        line = line.replace("-\n", "")
        line = line.replace("\n", " ")
        if "&" in line:
            line = line.replace("&quot;", '"')
            line = line.replace("&amp;", "&")
            line = line.replace("&lt;", "<")
            line = line.replace("&gt;", ">")
        return cls._tokenize_regex(f" {line} ")

    @classmethod
    def _tokenize_zh(cls, line: str) -> str:
        line = line.strip()
        line_in_chars = ""
        for char in line:
            if cls._is_chinese_char(char):
                line_in_chars += f" {char} "
            else:
                line_in_chars += char
        return cls._tokenize_regex(line_in_chars)

    @classmethod
    def _tokenize_international(cls, line: str) -> str:
        if not cls._REGEX_AVAILABLE:  # pragma: no cover
            raise ModuleNotFoundError("The `intl` tokenizer requires the `regex` package.")
        for _re, repl in cls._INT_REGEX:
            line = _re.sub(repl, line)
        return " ".join(line.split())

    @classmethod
    def _tokenize_char(cls, line: str) -> str:
        return " ".join(char for char in line)

    @staticmethod
    def _lower(line: str, lowercase: bool) -> str:
        return line.lower() if lowercase else line

    @classmethod
    def _check_tokenizers_validity(cls, tokenize: str) -> None:
        if tokenize in _UNSUPPORTED_TOKENIZERS:
            raise ValueError(
                f"Tokenizer {tokenize!r} needs an external segmenter (mecab/sentencepiece) that is not"
                f" available in this build; supported: {AVAILABLE_TOKENIZERS}."
            )
        if tokenize not in cls._TOKENIZE_FN:
            raise ValueError(f"Unsupported tokenizer selected. Please, choose one of {AVAILABLE_TOKENIZERS}")


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    weights: Optional[Sequence[float]] = None,
    device: Union[str, torch.device, None] = None,
) -> Tensor:
    """SacreBLEU (``sacre_bleu.py:159``), on ``device`` (CUDA unless named).

    Example:
        >>> from torchmetrics_tpu_torch.functional import sacre_bleu_score
        >>> preds = ["the cat is on the mat"]
        >>> target = [["the cat is on the mat"]]
        >>> print(f"{float(sacre_bleu_score(preds, target, device='cpu')):.4f}")
        1.0000
    """
    device = resolve_device(device)
    if len(preds) != len(target):
        raise ValueError(f"Corpus has different size {len(preds)} != {len(target)}")
    if weights is not None and len(weights) != n_gram:
        raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
    if weights is None:
        weights = [1.0 / n_gram] * n_gram
    tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)
    numerator = np.zeros(n_gram)
    denominator = np.zeros(n_gram)
    preds_len, target_len = _bleu_score_update_batched(
        preds, [[t] if isinstance(t, str) else t for t in target], numerator, denominator, 0.0, 0.0,
        n_gram, tokenizer,
    )
    return _bleu_score_compute(*_on_device(preds_len, target_len, numerator, denominator, device), n_gram, weights,
                               smooth)
