"""SQuAD exact match and F1 (counterpart of ``torchmetrics_tpu/functional/text/squad.py``, reference
``functional/text/squad.py``): the answer normalisation and token overlap are host work, copied; the
three sums go to the device."""
from __future__ import annotations

import re
import string
from collections import Counter
from typing import Any, Callable, Dict, List, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import resolve_device

SQuAD_FORMAT = {
    "answers": {"answer_start": [1], "text": ["This is a test text"]},
    "context": "This is a test context.",
    "id": "1",
    "question": "Is this a test?",
    "title": "train test",
}


def _normalize_text(s: str) -> str:
    """Lowercase, strip punctuation/articles/extra whitespace (reference ``squad.py:41``)."""
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def _get_tokens(s: str) -> List[str]:
    """Reference ``squad.py:60``."""
    return _normalize_text(s).split() if s else []


def _compute_f1_score(predicted_answer: str, target_answer: str) -> float:
    """Token-overlap F1 (reference ``squad.py:65``)."""
    target_tokens = _get_tokens(target_answer)
    predicted_tokens = _get_tokens(predicted_answer)
    common = Counter(target_tokens) & Counter(predicted_tokens)
    num_same = sum(common.values())
    if len(target_tokens) == 0 or len(predicted_tokens) == 0:
        return float(target_tokens == predicted_tokens)
    if num_same == 0:
        return 0.0
    precision = num_same / len(predicted_tokens)
    recall = num_same / len(target_tokens)
    return 2 * precision * recall / (precision + recall)


def _compute_exact_match_score(prediction: str, ground_truth: str) -> float:
    """Reference ``squad.py:81``."""
    return float(_normalize_text(prediction) == _normalize_text(ground_truth))


def _metric_max_over_ground_truths(metric_fn: Callable, prediction: str, ground_truths: List[str]) -> float:
    """Reference ``squad.py:86``."""
    return max(metric_fn(prediction, truth) for truth in ground_truths)


def _squad_input_check(preds, targets) -> Tuple[Dict[str, str], List[Dict[str, Any]]]:
    """Validate + canonicalize inputs (reference ``squad.py:93``)."""
    if isinstance(preds, dict):
        preds = [preds]
    if isinstance(targets, dict):
        targets = [targets]
    for pred in preds:
        if "prediction_text" not in pred or "id" not in pred:
            raise KeyError(
                "A single prediction must carry the keys 'prediction_text' (the answer string) and 'id'"
                " (the key string)."
            )
    for target in targets:
        if "answers" not in target or "id" not in target:
            raise KeyError(
                "A single target must carry the keys 'answers' (a `SQuAD` format dictionary) and 'id'"
                " (the key string).\n"
                f"SQuAD Format: {SQuAD_FORMAT}"
            )
        if "text" not in target["answers"]:
            raise KeyError(
                "The 'answers' entry must carry a 'text' key mapping to a `SQuAD` format dictionary.\n"
                f"SQuAD Format: {SQuAD_FORMAT}"
            )
    preds_dict = {p["id"]: p["prediction_text"] for p in preds}
    targets_dict = [
        {
            "paragraphs": [
                {
                    "qas": [
                        {"answers": [{"text": txt} for txt in t["answers"]["text"]], "id": t["id"]}
                        for t in targets
                    ]
                }
            ]
        }
    ]
    return preds_dict, targets_dict


def _squad_update(preds: Dict[str, str], target: List[Dict[str, Any]]) -> Tuple[float, float, int]:
    """(F1 sum, exact-match sum, question count) on the host (``squad.py:99``)."""
    f1 = 0.0
    exact_match = 0.0
    total = 0
    for article in target:
        for paragraph in article["paragraphs"]:
            for qa in paragraph["qas"]:
                total += 1
                if qa["id"] not in preds:
                    continue
                ground_truths = [answer["text"] for answer in qa["answers"]]
                prediction = preds[qa["id"]]
                exact_match += _metric_max_over_ground_truths(_compute_exact_match_score, prediction, ground_truths)
                f1 += _metric_max_over_ground_truths(_compute_f1_score, prediction, ground_truths)
    return f1, exact_match, total


def _squad_compute(f1: Tensor, exact_match: Tensor, total: Tensor) -> Dict[str, Tensor]:
    """``squad.py:117``."""
    return {"exact_match": 100.0 * exact_match / total, "f1": 100.0 * f1 / total}


def squad(preds, target, device: Union[str, torch.device, None] = None) -> Dict[str, Tensor]:
    """SQuAD exact match and F1 (``squad.py:122``), on ``device`` (CUDA unless named).

    Example:
        >>> from torchmetrics_tpu_torch.functional import squad
        >>> preds = [{'prediction_text': 'the cat', 'id': '1'}]
        >>> target = [{'answers': {'answer_start': [0], 'text': ['the cat']}, 'id': '1'}]
        >>> out = squad(preds, target, device='cpu')
        >>> print(f"{float(out['exact_match']):.1f} {float(out['f1']):.1f}")
        100.0 100.0
    """
    device = resolve_device(device)
    preds_dict, target_dict = _squad_input_check(preds, target)
    sums = torch.tensor(_squad_update(preds_dict, target_dict), dtype=torch.float32, device=device)
    return _squad_compute(*sums.unbind())
