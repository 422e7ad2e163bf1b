"""Permutation-invariant training (counterpart of ``torchmetrics_tpu/functional/audio/pit.py``).

As in the JAX package, the speaker-pair metric matrix comes from one call of ``metric_func`` over all
``S × S`` (target, pred) pairs folded into the batch axis (``permutation-wise``: over all ``S!``
permuted stacks), and the best assignment is an exhaustive search over the ``S!`` permutations, one
gather and one ``argmax``/``argmin``: ties go to the first permutation, as in ``jnp.argmax``.

The permutation table is built on the device in ``itertools.permutations``' order from ``arange``
(the factorial number system), so an update captured as a CUDA graph copies nothing from the host;
it is cached per speaker count and device once made outside a capture.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

_PERM_CACHE: Dict[Tuple[int, torch.device], Tensor] = {}


def _permutation_table(spk_num: int, device: torch.device) -> Tensor:
    """All ``S!`` permutations of ``range(S)`` as a ``(S!, S)`` int64 table in lexicographic order:
    row ``k``'s digit ``i`` in the factorial base picks the ``d``-th speaker not yet taken."""
    count = math.factorial(spk_num)
    rank = torch.arange(count, device=device)
    speakers = torch.arange(spk_num, device=device)
    free = torch.ones((count, spk_num), dtype=torch.bool, device=device)
    columns = []
    for i in range(spk_num):
        digit = torch.div(rank, math.factorial(spk_num - 1 - i), rounding_mode="floor") % (spk_num - i)
        seen = torch.cumsum(free.to(torch.int64), dim=1)
        pick = torch.argmax(((seen == (digit + 1)[:, None]) & free).to(torch.int64), dim=1)
        columns.append(pick)
        free = free & (speakers[None, :] != pick[:, None])
    return torch.stack(columns, dim=1)


def _gen_permutations(spk_num: int, device: torch.device) -> Tensor:
    """The permutation table of ``spk_num`` speakers on ``device`` (JAX ``pit.py:24``)."""
    key = (spk_num, torch.device(device))
    table = _PERM_CACHE.get(key)
    if table is None:
        table = _permutation_table(spk_num, key[1])
        if not (table.is_cuda and torch.cuda.is_current_stream_capturing()):  # not in a graph's pool
            _PERM_CACHE[key] = table
    return table


def permutation_invariant_training(
    preds: Tensor,
    target: Tensor,
    metric_func: Callable,
    mode: str = "speaker-wise",
    eval_func: str = "max",
    **kwargs: Any,
) -> Tuple[Tensor, Tensor]:
    """PIT (JAX ``pit.py:34``): the best metric and its permutation per batch element.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import (permutation_invariant_training,
        ...     scale_invariant_signal_noise_ratio)
        >>> preds = torch.tensor([[[0.6, 0.4, 0.2], [0.2, 0.4, 0.6]]])
        >>> target = torch.tensor([[[0.2, 0.4, 0.6], [0.6, 0.4, 0.2]]])
        >>> best, perm = permutation_invariant_training(preds, target, scale_invariant_signal_noise_ratio)
        >>> perm.tolist()
        [[1, 0]]
    """
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    if preds.shape[0:2] != target.shape[0:2]:
        raise RuntimeError(
            "Predictions and targets are expected to have the same shape at the batch and speaker dimensions"
        )
    if eval_func not in ["max", "min"]:
        raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
    if mode not in ["speaker-wise", "permutation-wise"]:
        raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
    if target.ndim < 2:
        raise ValueError(
            f"Inputs must be of shape [batch, spk, ...], got {tuple(target.shape)} and {tuple(preds.shape)} instead"
        )

    batch_size, spk_num = target.shape[0:2]
    if spk_num > 8:
        rank_zero_warn(
            f"Exhaustive permutation search over {spk_num}! assignments is expensive; PIT is exact"
            " but consider fewer speakers."
        )
    perms = _gen_permutations(spk_num, preds.device)  # (perm_num, S)
    perm_num = perms.shape[0]

    if mode == "permutation-wise":
        # metric_func once over all permuted stacks folded into the batch axis, with the keywords
        ppreds = preds[:, perms.reshape(-1)].reshape(batch_size * perm_num, *preds.shape[1:])
        ptarget = torch.repeat_interleave(target, perm_num, dim=0)
        metric_of_ps = metric_func(ppreds, ptarget, **kwargs)
        metric_of_ps = torch.mean(metric_of_ps.reshape(batch_size, perm_num, -1), dim=-1)
    else:
        # one call over all S x S (target, pred) speaker pairs folded into the batch axis
        rest = preds.shape[2:]
        p = preds[:, None].expand(batch_size, spk_num, spk_num, *rest)
        t = target[:, :, None].expand(batch_size, spk_num, spk_num, *rest)
        flat = metric_func(p.reshape(batch_size * spk_num * spk_num, *rest),
                           t.reshape(batch_size * spk_num * spk_num, *rest), **kwargs)
        metric_mtx = flat.reshape(batch_size, spk_num, spk_num)  # [b, target_idx, preds_idx]
        # a permutation's score: the mean over target_idx of mtx[target_idx, perm[target_idx]]
        rows = torch.arange(spk_num, device=preds.device)
        metric_of_ps = torch.mean(metric_mtx[:, rows[None, :], perms], dim=-1).reshape(batch_size, perm_num)

    if eval_func == "max":
        best_metric, best_indexes = torch.max(metric_of_ps, dim=1)
    else:
        best_metric, best_indexes = torch.min(metric_of_ps, dim=1)
    return best_metric, perms[best_indexes]


def pit_permutate(preds: Tensor, perm: Tensor) -> Tensor:
    """Reorder the speakers of ``preds`` by each sample's permutation (JAX ``pit.py:107``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import pit_permutate
        >>> preds = torch.tensor([[[0.6, 0.4, 0.2], [0.2, 0.4, 0.6]]])
        >>> pit_permutate(preds, torch.tensor([[1, 0]])).tolist()
        [[[0.20000000298023224, 0.4000000059604645, 0.6000000238418579], [0.6000000238418579, 0.4000000059604645, 0.20000000298023224]]]
    """
    preds, perm = torch.as_tensor(preds), torch.as_tensor(perm, device=torch.as_tensor(preds).device)
    index = perm.reshape(*perm.shape, *([1] * (preds.ndim - 2))).expand(*perm.shape, *preds.shape[2:])
    return torch.gather(preds, 1, index.to(torch.int64))
