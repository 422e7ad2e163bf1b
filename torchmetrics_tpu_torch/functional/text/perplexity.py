"""Perplexity (counterpart of ``torchmetrics_tpu/functional/text/perplexity.py``, reference
``functional/text/perplexity.py``).

On the device, with no host read, so a graph can capture the update. As in JAX (``perplexity.py:44-54``)
the logits are cast to float32 and go through a whole log-softmax before the targets' gather: PyTorch's
``log_softmax`` is one fused kernel, which passes over each row for its maximum and its sum and writes
the ``(B·L, V)`` output once. ``torch.logsumexp`` less the target's logit writes no log-softmax, but it
takes an ``amax`` pass, writes ``x - max`` to a temporary of the logits' size, exponentiates that in place
and sums it, so it moves more bytes (``PERF.md`` §5 has both on the card). ``ignore_index`` is a mask and a weight, as in JAX, with no boolean
indexing.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor


def _check_shape_and_type_consistency(preds: Tensor, target: Tensor) -> None:
    """The host checks of ``perplexity.py:17-41``."""
    if preds.ndim != 3:
        raise ValueError(
            "Input tensor `preds` is expected to have 3 dimensions, [batch_size, seq_len, vocab_size],"
            f" but got {preds.ndim}."
        )
    if target.ndim != 2:
        raise ValueError(
            "Input tensor `target` is expected to have 2 dimensions, [batch_size, seq_len],"
            f" but got {target.ndim}."
        )
    if tuple(preds.shape[:2]) != tuple(target.shape):
        raise ValueError(
            "Input tensors `preds` and `target` are expected to have equaling first two dimensions,"
            f" [batch_size, seq_len], but got {tuple(preds.shape[:2])} and {tuple(target.shape)}."
        )
    if not preds.is_floating_point():
        raise TypeError(f"Input tensor `preds` must be of floating point type but got {preds.dtype}.")
    if target.is_floating_point() or target.is_complex() or target.dtype == torch.bool:
        raise TypeError(f"Input tensor `target` is expected to be of integer type but got {target.dtype}.")


def _perplexity_update(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """(negated sum of the targets' log-probabilities, token count), float32 (``perplexity.py:44``)."""
    logits = preds.reshape(-1, preds.shape[-1]).to(torch.float32)
    target = target.reshape(-1).to(torch.int64)
    if ignore_index is not None:
        keep = target != ignore_index
        mask = keep.to(torch.float32)
        target = torch.where(keep, target, 0)
    else:
        mask = torch.ones(target.shape, dtype=torch.float32, device=target.device)
    token_lp = torch.log_softmax(logits, dim=-1).gather(1, target[:, None])[:, 0]
    return -torch.sum(token_lp * mask), torch.sum(mask)


def _perplexity_compute(total: Tensor, count: Tensor) -> Tensor:
    """``exp`` of the mean negative log-likelihood (``perplexity.py:57``)."""
    return torch.exp(total / count)


def perplexity(preds: Tensor, target: Tensor, ignore_index: Optional[int] = None) -> Tensor:
    """Perplexity of a language model's logits (``perplexity.py:62``), on the logits' device.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import perplexity
        >>> logits = torch.log(torch.tensor([[[0.6, 0.4], [0.3, 0.7]]]))
        >>> print(f"{float(perplexity(logits, torch.tensor([[0, 1]]))):.3f}")
        1.543
    """
    preds, target = torch.as_tensor(preds), torch.as_tensor(target, device=torch.as_tensor(preds).device)
    _check_shape_and_type_consistency(preds, target)
    total, count = _perplexity_update(preds, target, ignore_index)
    return _perplexity_compute(total, count)
