"""Extended edit distance (counterpart of ``torchmetrics_tpu/functional/text/eed.py``, reference
``functional/text/eed.py``).

The CDER-grid DP over characters, host work copied from the JAX package: vectorised in numpy over the
hypothesis axis, with the deletion chain of each row kept as a sequential loop (``eed.py:44-53``),
since the reference accumulates ``+deletion`` step by step and a closed form differs in the last ulp,
enough to flip the argmin ties that set the coverage term. The per-sentence scores go to the device.
"""
from __future__ import annotations

import re
import unicodedata
from math import inf
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.text.ter import _validate_inputs
from torchmetrics_tpu_torch.metric import resolve_device


def _eed_function(
    hyp: str,
    ref: str,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
) -> float:
    """EED over character sequences (reference ``eed.py:117-172``)."""
    h = len(hyp)
    hyp_chars = np.frombuffer(hyp.encode("utf-32-le"), np.uint32) if h else np.zeros(0, np.uint32)
    number_of_visits = np.full(h + 1, -1, np.int64)
    row = np.ones(h + 1)
    row[0] = 0.0

    for w in range(1, len(ref) + 1):
        ref_char = np.uint32(ord(ref[w - 1]))
        # substitution/insertion candidates, vectorised over the hypothesis axis
        base = np.empty(h + 1)
        base[0] = row[0] + 1.0
        if h:
            subst = row[:-1] + (hyp_chars != ref_char)
            base[1:] = np.minimum(subst, row[1:] + insertion)
        # deletion chain stays sequential: the reference accumulates `+deletion` one step at a
        # time, and a closed-form k*deletion differs in the last ulp — enough to flip argmin
        # ties and change the coverage term
        next_row = base
        prev = next_row[0]
        for i in range(1, h + 1):
            cand = prev + deletion
            if cand < next_row[i]:
                next_row[i] = cand
            prev = next_row[i]
        min_index = int(np.argmin(next_row))
        number_of_visits[min_index] += 1
        if ref[w - 1] == " ":
            jump = alpha + next_row[min_index]
            next_row = np.minimum(next_row, jump)
        row = next_row

    coverage = rho * float(np.where(number_of_visits >= 0, number_of_visits, 1).sum())
    return min(1.0, (row[-1] + coverage) / (float(len(ref)) + coverage))


def _preprocess_en(sentence: str) -> str:
    """English preprocessing rules (reference ``eed.py:175-215``)."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    sentence = sentence.rstrip()
    for pattern, replacement in ((".", " ."), ("!", " !"), ("?", " ?"), (",", " ,")):
        sentence = sentence.replace(pattern, replacement)
    rules_re = [
        (r"\s+", r" "),
        (r"(\d) ([.,]) (\d)", r"\1\2\3"),
        (r"(Dr|Jr|Prof|Rev|Gen|Mr|Mt|Mrs|Ms) .", r"\1."),
    ]
    for pattern, replacement in rules_re:
        sentence = re.sub(pattern, replacement, sentence)
    for pattern, replacement in (("e . g .", "e.g."), ("i . e .", "i.e."), ("U . S .", "U.S.")):
        sentence = sentence.replace(pattern, replacement)
    return " " + sentence + " "


def _preprocess_ja(sentence: str) -> str:
    """Japanese preprocessing (reference ``eed.py:218-233``)."""
    if not isinstance(sentence, str):
        raise ValueError(f"Only strings allowed during preprocessing step, found {type(sentence)} instead")
    return unicodedata.normalize("NFKC", sentence.rstrip())


def _eed_update(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    sentence_eed: Optional[List[float]] = None,
) -> List[float]:
    """Per-sentence best-over-references EED scores (reference ``eed.py:300-341``)."""
    target, preds = _validate_inputs(target, preds)
    if language == "en":
        preprocess = _preprocess_en
    elif language == "ja":
        preprocess = _preprocess_ja
    else:
        raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
    if sentence_eed is None:
        sentence_eed = []
    for pred, refs in zip(preds, target):
        pred_p = preprocess(pred)
        best = inf
        for ref in refs:
            score = _eed_function(pred_p, preprocess(ref), alpha, rho, deletion, insertion)
            best = min(best, score)
        sentence_eed.append(best)
    return sentence_eed


def extended_edit_distance(
    preds: Union[str, Sequence[str]],
    target: Sequence[Union[str, Sequence[str]]],
    language: str = "en",
    return_sentence_level_score: bool = False,
    alpha: float = 2.0,
    rho: float = 0.3,
    deletion: float = 0.2,
    insertion: float = 1.0,
    device: Union[str, torch.device, None] = None,
):
    """EED (``eed.py:121``), on ``device`` (CUDA unless named): the mean of the sentences' scores (a
    float64 numpy mean, as in JAX), and with sentence scores a list of one-element tensors.

    Example:
        >>> from torchmetrics_tpu_torch.functional import extended_edit_distance
        >>> preds = ["this is the prediction"]
        >>> target = ["this is the reference"]
        >>> print(f"{float(extended_edit_distance(preds, target, device='cpu')):.4f}")
        0.3835
    """
    for name, val in (("alpha", alpha), ("rho", rho), ("deletion", deletion), ("insertion", insertion)):
        if not isinstance(val, float) or val < 0:
            raise ValueError(f"Parameter `{name}` must be a non-negative float.")
    device = resolve_device(device)
    sentence_eed = _eed_update(preds, target, language, alpha, rho, deletion, insertion)
    if not sentence_eed:
        return torch.zeros((), dtype=torch.float32, device=device)
    avg = torch.tensor(float(np.mean(sentence_eed)), dtype=torch.float32, device=device)
    if return_sentence_level_score:
        return avg, list(torch.tensor(sentence_eed, dtype=torch.float32, device=device)[:, None])
    return avg
