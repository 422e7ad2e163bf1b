"""Word, character and match error rates and the word-information metrics (counterpart of
``torchmetrics_tpu/functional/text/wer.py``, reference ``functional/text/{wer,cer,mer,wil,wip}.py``).

All five share the batched row scan of ``_edit.py``. The distances stay on the device and are summed
there; the lengths are host counts. The states are two to four float32 sums.
"""
from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.text._edit import _word_batch_stats, edit_distance_batch
from torchmetrics_tpu_torch.metric import resolve_device

Device = Union[str, torch.device, None]


def _as_list(x: Union[str, List[str]]) -> List[str]:
    return [x] if isinstance(x, str) else list(x)


def _on(value: float, device: torch.device) -> Tensor:
    return torch.tensor(float(value), dtype=torch.float32, device=device)


def _wer_update(preds, target, device: Device = None) -> Tuple[Tensor, Tensor]:
    """Summed edit operations and reference word count (``wer.py:22``)."""
    device = resolve_device(device)
    preds, target = _as_list(preds), _as_list(target)
    d, _, t_len = _word_batch_stats(preds, target, str.split, device)
    return d.sum(), _on(t_len.sum(), device)


def _wer_compute(errors: Tensor, total: Tensor) -> Tensor:
    """``wer.py:29``."""
    return errors / total


def word_error_rate(preds, target, device: Device = None) -> Tensor:
    """Word error rate (``wer.py:34``), on ``device`` (CUDA unless named).

    Example:
        >>> from torchmetrics_tpu_torch.functional import word_error_rate
        >>> print(f"{float(word_error_rate(['the cat sat'], ['the cat sat down'], device='cpu')):.4f}")
        0.2500
    """
    return _wer_compute(*_wer_update(preds, target, device))


def _cer_update(preds, target, device: Device = None) -> Tuple[Tensor, Tensor]:
    """Character errors and reference character count (``wer.py:45``)."""
    device = resolve_device(device)
    preds, target = _as_list(preds), _as_list(target)
    d = edit_distance_batch([list(p) for p in preds], [list(t) for t in target], device=device)
    return d.sum(), _on(sum(len(t) for t in target), device)


def _cer_compute(errors: Tensor, total: Tensor) -> Tensor:
    """``wer.py:53``."""
    return errors / total


def char_error_rate(preds, target, device: Device = None) -> Tensor:
    """Character error rate (``wer.py:58``), on ``device`` (CUDA unless named).

    Example:
        >>> from torchmetrics_tpu_torch.functional import char_error_rate
        >>> print(f"{float(char_error_rate(['abcd'], ['abce'], device='cpu')):.4f}")
        0.2500
    """
    return _cer_compute(*_cer_update(preds, target, device))


def _mer_update(preds, target, device: Device = None) -> Tuple[Tensor, Tensor]:
    """Errors and the sum of ``max(len_t, len_p)`` (``wer.py:69``)."""
    device = resolve_device(device)
    preds, target = _as_list(preds), _as_list(target)
    d, p_len, t_len = _word_batch_stats(preds, target, str.split, device)
    return d.sum(), _on(np.maximum(p_len, t_len).sum(), device)


def _mer_compute(errors: Tensor, total: Tensor) -> Tensor:
    """``wer.py:77``."""
    return errors / total


def match_error_rate(preds, target, device: Device = None) -> Tensor:
    """Match error rate (``wer.py:82``), on ``device`` (CUDA unless named).

    Example:
        >>> from torchmetrics_tpu_torch.functional import match_error_rate
        >>> print(f"{float(match_error_rate(['the cat sat'], ['the cat sat down'], device='cpu')):.4f}")
        0.2500
    """
    return _mer_compute(*_mer_update(preds, target, device))


def _word_info_update(preds, target, device: Device = None) -> Tuple[Tensor, Tensor, Tensor]:
    """The WIL and WIP statistics (``wer.py:93``): errors less the ``max(len_t, len_p)`` total, and
    the two word counts."""
    device = resolve_device(device)
    preds, target = _as_list(preds), _as_list(target)
    d, p_len, t_len = _word_batch_stats(preds, target, str.split, device)
    total = np.maximum(p_len, t_len).sum()
    return d.sum() - _on(total, device), _on(t_len.sum(), device), _on(p_len.sum(), device)


def _word_info_lost_compute(errors: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    """``wer.py:106``."""
    return 1 - (errors / target_total) * (errors / preds_total)


def word_information_lost(preds, target, device: Device = None) -> Tensor:
    """Word information lost (``wer.py:111``), on ``device`` (CUDA unless named).

    Example:
        >>> from torchmetrics_tpu_torch.functional import word_information_lost
        >>> print(f"{float(word_information_lost(['the cat sat'], ['the cat sat down'], device='cpu')):.4f}")
        0.2500
    """
    return _word_info_lost_compute(*_word_info_update(preds, target, device))


def _wip_compute(errors: Tensor, target_total: Tensor, preds_total: Tensor) -> Tensor:
    """``wer.py:122``."""
    return (errors / target_total) * (errors / preds_total)


def word_information_preserved(preds, target, device: Device = None) -> Tensor:
    """Word information preserved (``wer.py:127``), on ``device`` (CUDA unless named).

    Example:
        >>> from torchmetrics_tpu_torch.functional import word_information_preserved
        >>> print(f"{float(word_information_preserved(['the cat sat'], ['the cat sat down'], device='cpu')):.4f}")
        0.7500
    """
    return _wip_compute(*_word_info_update(preds, target, device))
