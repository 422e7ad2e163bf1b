"""Module text metrics (counterpart of ``torchmetrics_tpu/text/metrics.py``): the 14 classes that need no
model, and the two encoder-backed ones, ``BERTScore`` and ``InfoLM`` (``metrics.py:663-916``).

Strings cannot be captured, so the updates of ``_HostTextMetric`` (``metrics.py:42``) run the host
counting of the functional modules and add the batch's numbers to fixed-shape states on the device,
eagerly on either dispatch tier (``jit_update = False``: the graph gate notes ``jit_update_off`` where
``fast_update`` is asked for, as for FID). The edit-distance metrics run the batched row scan of
``functional/text/_edit.py`` on the device inside their update, one graph replay on the graph tier.
The computes are tensor code on the states. ``Perplexity`` is an ordinary metric: its update is
tensor code, captured on the graph tier like any other.

``BERTScore`` and ``InfoLM`` keep their raw sentences in host lists until ``compute``, which scores them
through the functional entries on the metric's device; ``forward`` scores its batch alone. As in JAX they
have no states to sync (``_SentenceStoreTextMetric``).

State layouts follow the JAX package: BLEU keeps ``(n_gram,)`` count vectors, the error rates two to
four float32 sums, chrF six per-order vectors. Where JAX appends a one-element tensor per sentence
to a sentence-level list (TER, EED, ROUGE), the port appends one tensor per update holding the
batch's sentences: the concatenated state, and so every value, sync and ``load_numpy_state``, is the
same, with one host-to-device copy an update in place of one a sentence.
"""
from __future__ import annotations

from typing import Any, Dict, List, Literal, Optional, Sequence, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text.bleu import (
    _bleu_score_compute,
    _bleu_score_update_batched,
    _on_device,
    _tokenize_fn,
)
from torchmetrics_tpu_torch.functional.text.chrf import (
    _chrf_score_compute,
    _chrf_score_update_batched,
    _validate_chrf_args,
)
from torchmetrics_tpu_torch.functional.text.edit import _edit_distance_compute, _edit_distance_update
from torchmetrics_tpu_torch.functional.text.eed import _eed_update
from torchmetrics_tpu_torch.functional.text.perplexity import (
    _check_shape_and_type_consistency,
    _perplexity_compute,
    _perplexity_update,
)
from torchmetrics_tpu_torch.functional.text.rouge import (
    ALLOWED_ROUGE_KEYS,
    _check_rouge_args,
    _rouge_score_update,
    _stemmer_or_none,
)
from torchmetrics_tpu_torch.functional.text.sacre_bleu import AVAILABLE_TOKENIZERS, _SacreBLEUTokenizer
from torchmetrics_tpu_torch.functional.text.squad import _squad_compute, _squad_input_check, _squad_update
from torchmetrics_tpu_torch.functional.text.ter import _TercomTokenizer, _ter_update
from torchmetrics_tpu_torch.functional.text.wer import (
    _cer_update,
    _mer_update,
    _wer_update,
    _wip_compute,
    _word_info_lost_compute,
    _word_info_update,
)
from torchmetrics_tpu_torch.metric import Metric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

_SCORES = ("fmeasure", "precision", "recall")


def _zeros(metric: Metric, size: Optional[int] = None) -> Tensor:
    shape = () if size is None else (size,)
    return torch.zeros(shape, dtype=torch.float32, device=metric.device)


class _HostTextMetric(Metric):
    """Shared shell (``metrics.py:42``): an update over strings on the host into device states."""

    jit_update = False
    scan_update = False
    is_differentiable = False
    full_state_update = True

    def _host_tensor(self, values: Sequence[float]) -> Tensor:
        """Host numbers as one float32 tensor on the metric's device: one copy."""
        return torch.tensor(values, dtype=torch.float32, device=self.device)


class BLEUScore(_HostTextMetric):
    """BLEU (``metrics.py:62``).

    Example:
        >>> from torchmetrics_tpu_torch.text import BLEUScore
        >>> metric = BLEUScore(device="cpu")
        >>> metric.update(["the cat is on the mat"], [["the cat is on the mat"]])
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, n_gram: int = 4, smooth: bool = False, weights: Optional[Sequence[float]] = None,
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.n_gram = n_gram
        self.smooth = smooth
        if weights is not None and len(weights) != n_gram:
            raise ValueError(f"List of weights has different weights than `n_gram`: {len(weights)} != {n_gram}")
        self.weights = weights if weights is not None else [1.0 / n_gram] * n_gram
        self.add_state("preds_len", _zeros(self), dist_reduce_fx="sum")
        self.add_state("target_len", _zeros(self), dist_reduce_fx="sum")
        self.add_state("numerator", _zeros(self, n_gram), dist_reduce_fx="sum")
        self.add_state("denominator", _zeros(self, n_gram), dist_reduce_fx="sum")

    _tokenizer = staticmethod(_tokenize_fn)

    def _update(self, state: Dict[str, Tensor], preds: Sequence[str],
                target: Sequence[Union[str, Sequence[str]]]) -> Dict[str, Tensor]:
        preds_ = [preds] if isinstance(preds, str) else preds
        target_ = [[t] if isinstance(t, str) else t for t in target]
        num, den = np.zeros(self.n_gram), np.zeros(self.n_gram)
        p_len, t_len = _bleu_score_update_batched(preds_, target_, num, den, 0.0, 0.0, self.n_gram, self._tokenizer)
        batch = _on_device(p_len, t_len, num, den, self.device)
        return {k: state[k] + b for k, b in zip(("preds_len", "target_len", "numerator", "denominator"), batch)}

    def _compute(self, state: Dict[str, Tensor]) -> Tensor:
        return _bleu_score_compute(state["preds_len"], state["target_len"], state["numerator"], state["denominator"],
                                   self.n_gram, self.weights, self.smooth)


class SacreBLEUScore(BLEUScore):
    """SacreBLEU (``metrics.py:116``).

    Example:
        >>> from torchmetrics_tpu_torch.text import SacreBLEUScore
        >>> metric = SacreBLEUScore(device="cpu")
        >>> metric.update(["the cat is on the mat"], [["the cat is on the mat"]])
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    def __init__(self, n_gram: int = 4, smooth: bool = False, tokenize: str = "13a", lowercase: bool = False,
                 weights: Optional[Sequence[float]] = None, **kwargs: Any) -> None:
        super().__init__(n_gram=n_gram, smooth=smooth, weights=weights, **kwargs)
        if tokenize not in AVAILABLE_TOKENIZERS:
            _SacreBLEUTokenizer._check_tokenizers_validity(tokenize)
        self._tokenizer = _SacreBLEUTokenizer(tokenize, lowercase)


class _ErrorRateMetric(_HostTextMetric):
    """The errors and total sums of WER, CER and MER (``metrics.py:141``)."""

    higher_is_better = False
    plot_lower_bound = 0.0

    _update_fn = None  # set per subclass

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", _zeros(self), dist_reduce_fx="sum")
        self.add_state("total", _zeros(self), dist_reduce_fx="sum")

    def _update(self, state: Dict[str, Tensor], preds: Union[str, List[str]], target: Union[str, List[str]]
                ) -> Dict[str, Tensor]:
        errors, total = type(self)._update_fn(preds, target, self.device)
        return {"errors": state["errors"] + errors, "total": state["total"] + total}

    def _compute(self, state: Dict[str, Tensor]) -> Tensor:
        return state["errors"] / state["total"]


class WordErrorRate(_ErrorRateMetric):
    """WER (``metrics.py:162``).

    Example:
        >>> from torchmetrics_tpu_torch.text import WordErrorRate
        >>> metric = WordErrorRate(device="cpu")
        >>> metric.update(["this is the prediction"], ["this is the reference"])
        >>> print(f"{float(metric.compute()):.4f}")
        0.2500
    """

    _update_fn = staticmethod(_wer_update)


class CharErrorRate(_ErrorRateMetric):
    """CER (``metrics.py:177``).

    Example:
        >>> from torchmetrics_tpu_torch.text import CharErrorRate
        >>> metric = CharErrorRate(device="cpu")
        >>> metric.update(["abcd"], ["abce"])
        >>> print(f"{float(metric.compute()):.4f}")
        0.2500
    """

    _update_fn = staticmethod(_cer_update)


class MatchErrorRate(_ErrorRateMetric):
    """MER (``metrics.py:192``).

    Example:
        >>> from torchmetrics_tpu_torch.text import MatchErrorRate
        >>> metric = MatchErrorRate(device="cpu")
        >>> metric.update(["this is the prediction"], ["this is the reference"])
        >>> print(f"{float(metric.compute()):.4f}")
        0.2500
    """

    _update_fn = staticmethod(_mer_update)


class _WordInfoMetric(_HostTextMetric):
    """The three sums of WIL and WIP (``metrics.py:207``)."""

    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", _zeros(self), dist_reduce_fx="sum")
        self.add_state("target_total", _zeros(self), dist_reduce_fx="sum")
        self.add_state("preds_total", _zeros(self), dist_reduce_fx="sum")

    def _update(self, state: Dict[str, Tensor], preds: Union[str, List[str]], target: Union[str, List[str]]
                ) -> Dict[str, Tensor]:
        errors, target_total, preds_total = _word_info_update(preds, target, self.device)
        return {"errors": state["errors"] + errors, "target_total": state["target_total"] + target_total,
                "preds_total": state["preds_total"] + preds_total}


class WordInfoLost(_WordInfoMetric):
    """WIL (``metrics.py:227``).

    Example:
        >>> from torchmetrics_tpu_torch.text import WordInfoLost
        >>> metric = WordInfoLost(device="cpu")
        >>> metric.update(["this is the prediction"], ["this is the reference"])
        >>> print(f"{float(metric.compute()):.4f}")
        0.4375
    """

    higher_is_better = False

    def _compute(self, state: Dict[str, Tensor]) -> Tensor:
        return _word_info_lost_compute(state["errors"], state["target_total"], state["preds_total"])


class WordInfoPreserved(_WordInfoMetric):
    """WIP (``metrics.py:245``).

    Example:
        >>> from torchmetrics_tpu_torch.text import WordInfoPreserved
        >>> metric = WordInfoPreserved(device="cpu")
        >>> metric.update(["this is the prediction"], ["this is the reference"])
        >>> print(f"{float(metric.compute()):.4f}")
        0.5625
    """

    higher_is_better = True

    def _compute(self, state: Dict[str, Tensor]) -> Tensor:
        return _wip_compute(state["errors"], state["target_total"], state["preds_total"])


class EditDistance(_HostTextMetric):
    """Levenshtein edit distance (``metrics.py:263``): ``edit_scores_list``, a ``cat`` list of int32
    distances, under ``reduction="none"``; two float32 sums otherwise.

    Example:
        >>> from torchmetrics_tpu_torch.text import EditDistance
        >>> metric = EditDistance(device="cpu")
        >>> metric.update(["abcd"], ["abce"])
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    higher_is_better = False
    plot_lower_bound = 0.0

    def __init__(self, substitution_cost: int = 1, reduction: Optional[Literal["mean", "sum", "none"]] = "mean",
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not (isinstance(substitution_cost, int) and substitution_cost >= 0):
            raise ValueError(f"Argument `substitution_cost` must be a positive integer, but got {substitution_cost}")
        allowed = ("mean", "sum", "none", None)
        if reduction not in allowed:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed}, but got {reduction}")
        self.substitution_cost = substitution_cost
        self.reduction = reduction
        if reduction == "none" or reduction is None:
            self.add_state("edit_scores_list", default=[], dist_reduce_fx="cat")
        else:
            self.add_state("edit_scores", _zeros(self), dist_reduce_fx="sum")
            self.add_state("num_elements", _zeros(self), dist_reduce_fx="sum")

    def _update(self, state: Dict[str, Tensor], preds: Union[str, Sequence[str]],
                target: Union[str, Sequence[str]]) -> Dict[str, Any]:
        distances = _edit_distance_update(preds, target, self.substitution_cost, self.device)
        if self.reduction == "none" or self.reduction is None:
            return {"edit_scores_list": distances}
        return {"edit_scores": state["edit_scores"] + torch.sum(distances, dtype=torch.int32),
                "num_elements": state["num_elements"] + distances.numel()}

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        if self.reduction == "none" or self.reduction is None:
            scores = dim_zero_cat(state["edit_scores_list"])  # raises before the first update, as JAX's does
            return _edit_distance_compute(scores, scores.numel(), self.reduction)
        return _edit_distance_compute(state["edit_scores"], state["num_elements"], self.reduction)


class Perplexity(Metric):
    """Perplexity (``metrics.py:316``): tensor code on the device, captured on the graph tier.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.text import Perplexity
        >>> probs = torch.tensor([[[0.4, 0.3, 0.3], [0.1, 0.8, 0.1]]])
        >>> metric = Perplexity(device="cpu")
        >>> metric.update(probs, torch.tensor([[0, 1]]))
        >>> print(f"{float(metric.compute()):.4f}")
        2.3665
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound = 0.0

    def __init__(self, ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError(f"Argument `ignore_index` expected to either be `None` or an `int` but got {ignore_index}")
        self.ignore_index = ignore_index
        self.add_state("total_log_probs", _zeros(self), dist_reduce_fx="sum")
        self.add_state("count", _zeros(self), dist_reduce_fx="sum")

    def _validate(self, preds: Tensor, target: Tensor) -> None:
        _check_shape_and_type_consistency(preds, target)

    def _update(self, state: Dict[str, Tensor], preds: Tensor, target: Tensor) -> Dict[str, Tensor]:
        total, count = _perplexity_update(preds, target, self.ignore_index)
        return {"total_log_probs": state["total_log_probs"] + total, "count": state["count"] + count}

    def _compute(self, state: Dict[str, Tensor]) -> Tensor:
        return _perplexity_compute(state["total_log_probs"], state["count"])


class CHRFScore(_HostTextMetric):
    """chrF and chrF++ (``metrics.py:353``): six per-order vectors, and with sentence scores a ``cat``
    list of one float32 vector an update.

    Example:
        >>> from torchmetrics_tpu_torch.text import CHRFScore
        >>> metric = CHRFScore(device="cpu")
        >>> metric.update(["the cat"], [["the cat"]])
        >>> print(f"{float(metric.compute()):.4f}")
        1.0000
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    _STATE_KEYS = ("preds_char", "preds_word", "target_char", "target_word", "matching_char", "matching_word")

    def __init__(self, n_char_order: int = 6, n_word_order: int = 2, beta: float = 2.0, lowercase: bool = False,
                 whitespace: bool = False, return_sentence_level_score: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        _validate_chrf_args(n_char_order, n_word_order, beta)
        self.n_char_order = n_char_order
        self.n_word_order = n_word_order
        self.beta = beta
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.return_sentence_level_score = return_sentence_level_score
        self.n_order = float(n_char_order + n_word_order)
        for key in self._STATE_KEYS:
            self.add_state(key, _zeros(self, n_char_order if key.endswith("char") else n_word_order),
                           dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_chrf_score", default=[], dist_reduce_fx="cat")

    def _update(self, state: Dict[str, Tensor], preds: Union[str, Sequence[str]],
                target: Union[Sequence[str], Sequence[Sequence[str]]]) -> Dict[str, Any]:
        totals = {k: np.zeros(self.n_char_order if k.endswith("char") else self.n_word_order, np.float32)
                  for k in self._STATE_KEYS}
        sentence_scores: Optional[List[float]] = [] if self.return_sentence_level_score else None
        _chrf_score_update_batched(preds, target, totals, self.n_char_order, self.n_word_order, self.n_order,
                                   self.beta, self.lowercase, self.whitespace, sentence_scores)
        packed = self._host_tensor(np.concatenate([totals[k] for k in self._STATE_KEYS]).tolist()
                                   + (sentence_scores or []))
        out: Dict[str, Any] = {}
        offset = 0
        for k in self._STATE_KEYS:
            n = len(totals[k])
            out[k] = state[k] + packed[offset:offset + n]
            offset += n
        if sentence_scores:
            out["sentence_chrf_score"] = packed[offset:]
        return out

    def _compute(self, state: Dict[str, Any]):
        score = _chrf_score_compute({k: state[k] for k in self._STATE_KEYS}, self.n_order, self.beta)
        if self.return_sentence_level_score:
            return score, dim_zero_cat(state["sentence_chrf_score"])  # raises before the first update, as JAX's does
        return score


class SQuAD(_HostTextMetric):
    """SQuAD exact match and F1 (``metrics.py:420``).

    Example:
        >>> from torchmetrics_tpu_torch.text import SQuAD
        >>> preds = [{"prediction_text": "the cat", "id": "1"}]
        >>> target = [{"answers": {"answer_start": [0], "text": ["the cat"]}, "id": "1"}]
        >>> metric = SQuAD(device="cpu")
        >>> metric.update(preds, target)
        >>> {k: float(v) for k, v in sorted(metric.compute().items())}
        {'exact_match': 100.0, 'f1': 100.0}
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 100.0

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", _zeros(self), dist_reduce_fx="sum")
        self.add_state("exact_match", _zeros(self), dist_reduce_fx="sum")
        self.add_state("total", _zeros(self), dist_reduce_fx="sum")

    def _update(self, state: Dict[str, Tensor], preds: Any, target: Any) -> Dict[str, Tensor]:
        preds_dict, target_dict = _squad_input_check(preds, target)
        f1, exact_match, total = self._host_tensor(_squad_update(preds_dict, target_dict)).unbind()
        return {"f1_score": state["f1_score"] + f1, "exact_match": state["exact_match"] + exact_match,
                "total": state["total"] + total}

    def _compute(self, state: Dict[str, Tensor]) -> Dict[str, Tensor]:
        return _squad_compute(state["f1_score"], state["exact_match"], state["total"])


class ROUGEScore(_HostTextMetric):
    """ROUGE-N, ROUGE-L and ROUGE-Lsum (``metrics.py:456``): a list state per key and score, with
    ``dist_reduce_fx=None`` (reference ``text/rouge.py:143``).

    Example:
        >>> from torchmetrics_tpu_torch.text import ROUGEScore
        >>> metric = ROUGEScore(rouge_keys=('rouge1',), device="cpu")
        >>> metric.update("the cat sat", "a cat sat")
        >>> {k: round(float(v), 4) for k, v in sorted(metric.compute().items())}
        {'rouge1_fmeasure': 0.6667, 'rouge1_precision': 0.6667, 'rouge1_recall': 0.6667}
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, use_stemmer: bool = False, normalizer=None, tokenizer=None, accumulate: str = "best",
                 rouge_keys=("rouge1", "rouge2", "rougeL", "rougeLsum"), **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.rouge_keys = _check_rouge_args(rouge_keys, accumulate)
        self.rouge_keys_values = [ALLOWED_ROUGE_KEYS[k] for k in self.rouge_keys]
        self.stemmer = _stemmer_or_none(use_stemmer)
        self.normalizer = normalizer
        self.tokenizer = tokenizer
        self.accumulate = accumulate
        for rouge_key in self.rouge_keys:
            for score in _SCORES:
                self.add_state(f"{rouge_key}_{score}", [], dist_reduce_fx=None)

    def _update(self, state: Dict[str, Tensor], preds: Union[str, Sequence[str]], target: Any) -> Dict[str, Tensor]:
        # the nesting rule of JAX's module (``metrics.py:543-551``): a flat list of target strings is one
        # multi-reference set for a single prediction
        if isinstance(preds, str):
            preds = [preds]
        if isinstance(target, str):
            target = [[target]]
        elif isinstance(target, list) and all(isinstance(tgt, str) for tgt in target):
            target = [[tgt] for tgt in target] if len(preds) > 1 else [list(target)]
        output = _rouge_score_update(preds, target, self.rouge_keys_values, accumulate=self.accumulate,
                                     stemmer=self.stemmer, normalizer=self.normalizer, tokenizer=self.tokenizer)
        names = [f"{key_name}_{tp}" for key_name in self.rouge_keys for tp in _SCORES]
        rows = [[s[tp] for s in output[key_val]] for key_val in self.rouge_keys_values for tp in _SCORES]
        n = len(rows[0])
        packed = self._host_tensor([v for row in rows for v in row])
        return {name: packed[i * n:(i + 1) * n] for i, name in enumerate(names)}

    def _compute(self, state: Dict[str, Any]) -> Dict[str, Tensor]:
        out: Dict[str, Tensor] = {}
        for rouge_key in self.rouge_keys:
            for score in _SCORES:
                vals = state[f"{rouge_key}_{score}"]
                out[f"{rouge_key}_{score}"] = (torch.mean(vals) if isinstance(vals, Tensor) and vals.numel()
                                               else _zeros(self))
        return out


class TranslationEditRate(_HostTextMetric):
    """TER (``metrics.py:562``).

    Example:
        >>> from torchmetrics_tpu_torch.text import TranslationEditRate
        >>> metric = TranslationEditRate(device="cpu")
        >>> metric.update(["the cat is on the mat"], [["the cat is on a mat"]])
        >>> print(f"{float(metric.compute()):.4f}")
        0.1667
    """

    higher_is_better = False
    plot_lower_bound = 0.0

    def __init__(self, normalize: bool = False, no_punctuation: bool = False, lowercase: bool = True,
                 asian_support: bool = False, return_sentence_level_score: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        for name, val in (
            ("normalize", normalize), ("no_punctuation", no_punctuation),
            ("lowercase", lowercase), ("asian_support", asian_support),
        ):
            if not isinstance(val, bool):
                raise ValueError(f"Expected argument `{name}` to be of type boolean but got {val}.")
        self.tokenizer = _TercomTokenizer(normalize, no_punctuation, lowercase, asian_support)
        self.return_sentence_level_score = return_sentence_level_score
        self.add_state("total_num_edits", _zeros(self), dist_reduce_fx="sum")
        self.add_state("total_tgt_len", _zeros(self), dist_reduce_fx="sum")
        if return_sentence_level_score:
            self.add_state("sentence_ter", [], dist_reduce_fx="cat")

    def _update(self, state: Dict[str, Tensor], preds: Union[str, Sequence[str]], target: Any) -> Dict[str, Tensor]:
        sentence: Optional[List[float]] = [] if self.return_sentence_level_score else None
        num_edits, tgt_len, sentence = _ter_update(preds, target, self.tokenizer, 0.0, 0.0, sentence)
        packed = self._host_tensor([num_edits, tgt_len] + (sentence or []))
        out = {"total_num_edits": state["total_num_edits"] + packed[0], "total_tgt_len": state["total_tgt_len"] + packed[1]}
        if sentence is not None:
            out["sentence_ter"] = packed[2:]
        return out

    def _compute(self, state: Dict[str, Any]):
        edits, tgt_len = state["total_num_edits"], state["total_tgt_len"]
        # the capturable form of _compute_ter_score_from_statistics (``metrics.py:625-629``)
        ter = torch.where((tgt_len > 0) & (edits > 0), edits / torch.where(tgt_len > 0, tgt_len, 1.0),
                          torch.where((tgt_len == 0) & (edits > 0), 1.0, 0.0))
        if self.return_sentence_level_score:
            sentences = state["sentence_ter"]
            return ter, sentences if isinstance(sentences, Tensor) else _zeros(self, 0)
        return ter


class ExtendedEditDistance(_HostTextMetric):
    """EED (``metrics.py:638``): the sentences' scores in a ``cat`` list, their mean the value.

    Example:
        >>> from torchmetrics_tpu_torch.text import ExtendedEditDistance
        >>> metric = ExtendedEditDistance(device="cpu")
        >>> metric.update(["this is the prediction"], ["this is the reference"])
        >>> print(f"{float(metric.compute()):.4f}")
        0.3835
    """

    higher_is_better = False
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(self, language: str = "en", return_sentence_level_score: bool = False, alpha: float = 2.0,
                 rho: float = 0.3, deletion: float = 0.2, insertion: float = 1.0, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if language not in ("en", "ja"):
            raise ValueError(f"Expected argument `language` to either be `en` or `ja` but got {language}")
        for name, val in (("alpha", alpha), ("rho", rho), ("deletion", deletion), ("insertion", insertion)):
            if not isinstance(val, float) or val < 0:
                raise ValueError(f"Parameter `{name}` must be a non-negative float.")
        self.language = language
        self.return_sentence_level_score = return_sentence_level_score
        self.alpha = alpha
        self.rho = rho
        self.deletion = deletion
        self.insertion = insertion
        self.add_state("sentence_eed", [], dist_reduce_fx="cat")

    def _update(self, state: Dict[str, Tensor], preds: Union[str, Sequence[str]], target: Any) -> Dict[str, Tensor]:
        scores = _eed_update(preds, target, self.language, self.alpha, self.rho, self.deletion, self.insertion)
        return {"sentence_eed": self._host_tensor(scores)}

    def _compute(self, state: Dict[str, Any]):
        sentences = state["sentence_eed"]
        if not isinstance(sentences, Tensor):
            sentences = _zeros(self, 0)
        avg = torch.mean(sentences) if sentences.numel() else _zeros(self)
        if self.return_sentence_level_score:
            return avg, sentences
        return avg


class _SentenceStoreTextMetric(_HostTextMetric):
    """The shell of the model-based text metrics, which keep raw sentences until ``compute`` (JAX
    ``metrics.py:663``).

    Strings cannot live in tensor states, so they are host lists: ``forward`` scores its batch alone, and
    ``reset`` clears them. Cross-process sync of these metrics is not supported, as in JAX (the reference
    syncs tokenised id tensors instead): gather the sentences outside, or compute per process. Their
    ``compute`` runs eagerly, outside the graph tier.
    """

    jit_compute = False  # compute reads the host sentence lists

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self._preds: list = []
        self._target: list = []

    @staticmethod
    def _coerce_sentences(preds, target):
        preds = [preds] if isinstance(preds, str) else list(preds)
        target = [target] if isinstance(target, str) else list(target)
        if len(preds) != len(target):
            raise ValueError(
                f"Number of predicted and reference sentences must match: {len(preds)} != {len(target)}"
            )
        return preds, target

    def update(self, preds, target) -> None:  # noqa: D102 - the sentences go to the host lists
        self._guard_synced("update")
        preds, target = self._coerce_sentences(preds, target)
        self._preds.extend(preds)
        self._target.extend(target)
        self._bump()

    def _score(self, preds: list, target: list):
        raise NotImplementedError

    def _compute(self, state: Dict[str, Any]):
        return self._score(self._preds, self._target)

    def forward(self, preds, target):  # noqa: D102 - the batch value is computed on the batch alone
        self.update(preds, target)
        return self._score(*self._coerce_sentences(preds, target))

    def reset(self) -> None:  # noqa: D102
        super().reset()
        self._preds = []
        self._target = []


def _check_inert_knobs(num_layers="skip", verbose="skip", device="skip", batch_size="skip",
                       num_threads="skip") -> None:
    """The reference's knobs sit mid-signature: a positional caller who binds a callable or a model to
    one of them gets an error, never silently wrong scores (JAX ``metrics.py:714``)."""
    if num_layers != "skip" and not (num_layers is None or isinstance(num_layers, int)):
        raise TypeError(f"`num_layers` must be an int or None, got {type(num_layers).__name__}")
    if verbose != "skip" and not isinstance(verbose, bool):
        raise TypeError(f"`verbose` must be a bool, got {type(verbose).__name__}")
    if device != "skip" and callable(device):
        raise TypeError("`device` received a callable — check your positional arguments")
    if batch_size != "skip" and not isinstance(batch_size, int):
        raise TypeError(f"`batch_size` must be an int, got {type(batch_size).__name__}")
    if num_threads != "skip" and not isinstance(num_threads, int):
        raise TypeError(f"`num_threads` must be an int, got {type(num_threads).__name__}")


class BERTScore(_SentenceStoreTextMetric):
    """BERTScore (JAX ``metrics.py:731``): the sentences accumulate on the host, and ``compute`` runs
    the greedy cosine matching of ``functional.text.bert_score`` on the metric's device.

    ``device`` is where the scores live, CUDA unless named; ``verbose``, ``batch_size`` and
    ``num_threads`` are the reference's and inert; ``baseline_url`` would need the network.

    Example:
        >>> import numpy as np, torch
        >>> from torchmetrics_tpu_torch.text import BERTScore
        >>> table = np.random.RandomState(0).randn(64, 8).astype(np.float32)
        >>> def toy_encoder(sentences):  # any callable (sentences) -> (emb, mask) works
        ...     rows = [[hash(w) % 64 for w in s.split()] for s in sentences]
        ...     width = max(len(r) for r in rows)
        ...     emb = np.zeros((len(rows), width, 8), np.float32)
        ...     mask = np.zeros((len(rows), width), np.int32)
        ...     for i, r in enumerate(rows):
        ...         emb[i, :len(r)], mask[i, :len(r)] = table[r], 1
        ...     return torch.from_numpy(emb), torch.from_numpy(mask)
        >>> metric = BERTScore(encoder=toy_encoder, device="cpu")
        >>> metric.update(["the cat sat"], ["the cat sat"])
        >>> print(f"{float(metric.compute()['f1'].reshape(-1)[0]):.4f}")
        1.0000
    """

    higher_is_better = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0

    def __init__(
        self,
        model_name_or_path: Optional[str] = None,
        num_layers: Optional[int] = None,
        all_layers: bool = False,
        model=None,
        user_tokenizer=None,
        user_forward_fn=None,
        verbose: bool = False,
        idf: bool = False,
        device=None,
        max_length: int = 512,
        batch_size: int = 64,
        num_threads: int = 0,
        return_hash: bool = False,
        lang: str = "en",
        rescale_with_baseline: bool = False,
        baseline_path: Optional[str] = None,
        baseline_url: Optional[str] = None,
        encoder=None,
        tokenize=None,
        **kwargs: Any,
    ) -> None:
        _check_inert_knobs(num_layers=num_layers, verbose=verbose, device=device, batch_size=batch_size,
                           num_threads=num_threads)
        super().__init__(device=device, **kwargs)
        if baseline_url is not None:
            rank_zero_warn("`baseline_url` needs network egress, which this build does not have;"
                           " pass `baseline_path` instead.")
        user_hooks = model is not None or user_tokenizer is not None or user_forward_fn is not None
        # the default model's encoder (the all_layers stack too) is built once, here, and reused by
        # every compute: building it per compute would reload the checkpoint each epoch
        if encoder is None and not user_hooks:
            from torchmetrics_tpu_torch.functional.text.bert import _DEFAULT_MODEL
            from torchmetrics_tpu_torch.utils.pretrained import bert_encoder as _build

            if model_name_or_path is None:
                rank_zero_warn(
                    "The argument `model_name_or_path` was not specified while it is required when the default"
                    " `transformers` model is used."
                    f" It will use the default recommended model - {_DEFAULT_MODEL!r}."
                )
                model_name_or_path = _DEFAULT_MODEL
            encoder, tokenize = _build(model_name_or_path, num_layers=num_layers, max_length=max_length,
                                       all_layers=all_layers, device=self.device)
        self.model_name_or_path = model_name_or_path
        self.encoder = encoder
        self.tokenize = tokenize
        self.num_layers = num_layers
        self.all_layers = all_layers
        self.own_model = model
        self.user_tokenizer = user_tokenizer
        self.user_forward_fn = user_forward_fn
        self.max_length = max_length
        self.return_hash = return_hash
        self.idf = idf
        self.rescale_with_baseline = rescale_with_baseline
        self.baseline_path = baseline_path
        self.lang = lang

    def _score(self, preds: list, target: list):
        from torchmetrics_tpu_torch.functional.text.bert import bert_score

        hooks = {}
        if self.own_model is not None or self.user_tokenizer is not None or self.user_forward_fn is not None:
            hooks = {"own_model": self.own_model, "user_tokenizer": self.user_tokenizer,
                     "user_forward_fn": self.user_forward_fn}
        return bert_score(
            preds, target, model_name_or_path=self.model_name_or_path, encoder=self.encoder, tokenize=self.tokenize,
            num_layers=self.num_layers, max_length=self.max_length, idf=self.idf,
            rescale_with_baseline=self.rescale_with_baseline, baseline_path=self.baseline_path, lang=self.lang,
            device=self.device, all_layers=self.all_layers, return_hash=self.return_hash, **hooks,
        )


class InfoLM(_SentenceStoreTextMetric):
    """InfoLM (JAX ``metrics.py:839``): a masked-LM callable and the reference's defaults
    (``bert-base-uncased``, ``temperature=0.25``, ``idf=True``); ``compute`` builds the bags and the
    measure on the metric's device. ``device`` is where the scores live, CUDA unless named.

    Example:
        >>> from torchmetrics_tpu_torch.text import InfoLM
        >>> metric = InfoLM('google/bert_uncased_L-2_H-128_A-2', idf=False)  # doctest: +SKIP
        >>> metric.update(['he read the book'], ['he reads the book'])  # doctest: +SKIP
        >>> metric.compute()  # doctest: +SKIP
    """

    higher_is_better = False
    plot_lower_bound = 0.0

    def __init__(
        self,
        model_name_or_path: str = "bert-base-uncased",
        temperature: float = 0.25,
        information_measure: str = "kl_divergence",
        idf: bool = True,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        device=None,
        max_length: Optional[int] = None,
        batch_size: int = 64,
        num_threads: int = 0,
        verbose: bool = True,
        return_sentence_level_score: bool = False,
        masked_lm=None,
        tokenize=None,
        **kwargs: Any,
    ) -> None:
        _check_inert_knobs(verbose=verbose, device=device, batch_size=batch_size, num_threads=num_threads)
        super().__init__(device=device, **kwargs)
        from torchmetrics_tpu_torch.functional.text.infolm import _hf_masked_lm, _validate_measure

        _validate_measure(information_measure, alpha, beta)
        if not (isinstance(temperature, (int, float)) and temperature > 0):
            raise ValueError(f"Argument `temperature` must be a positive number, but got {temperature}")
        if masked_lm is None:
            masked_lm, tokenize = _hf_masked_lm(model_name_or_path, max_length=max_length, temperature=temperature,
                                                device=self.device)
        if idf and tokenize is None:
            raise ValueError(
                "`idf=True` needs token ids: pass `tokenize` alongside a custom `masked_lm`, or use"
                " a HuggingFace `model_name_or_path` so the tokenizer is resolved automatically."
            )
        self.masked_lm = masked_lm
        self.tokenize = tokenize
        self.idf = idf
        self.information_measure = information_measure
        self.alpha = alpha
        self.beta = beta
        self.return_sentence_level_score = return_sentence_level_score

    def _score(self, preds: list, target: list):
        from torchmetrics_tpu_torch.functional.text.infolm import infolm

        return infolm(
            preds, target, masked_lm=self.masked_lm, tokenize=self.tokenize, idf=self.idf,
            information_measure=self.information_measure, alpha=self.alpha, beta=self.beta,
            return_sentence_level_score=self.return_sentence_level_score, device=self.device,
        )
