"""Batched Levenshtein edit distance on the device (counterpart of ``torchmetrics_tpu/functional/text/_edit.py``).

Tokens are interned to int ids on the host (the only step that reads strings), the pairs are padded
to a ``(B_pad, L)`` rectangle, and the DP runs on the device for the whole batch at once, as in the
JAX package (``_edit.py:34-66``):

- a loop over prediction positions carries the DP row of every pair, ``(B_pad, Lt + 1)``, with each
  pair's row frozen once its prediction has ended (the ``active`` mask of ``:43,58``);
- along a row the insertion chain ``new[j] = min(c[j], new[j-1] + 1)`` is solved in closed form,
  ``new[j] = j + cummin(c[k] - k)``: ``torch.cummin`` where JAX runs ``associative_scan(minimum)``.
  A minimum is exact, and the rows hold whole numbers in float32, so every order of the scan gives
  the same bits.

``B``, ``Lp`` and ``Lt`` are padded to powers of two, with the pad ids -1 (predictions) and -2
(targets) that never match (``:83-117``), so a stream of batches meets few shapes. JAX compiles the
scan once per padded shape (``@jax.jit``, ``:62``), and its jit cache holds no device buffers. The
port's graph tier captures the scan as a CUDA graph, which holds its static inputs and a private memory
pool for as long as it is kept, so the cache is bounded:

- the rows go in blocks of :data:`EDIT_BLOCK_ROWS`, the last block padded with empty pairs, so a graph
  is keyed by ``(Lp, Lt)`` and the substitution cost alone, and a batch of any size replays it once per
  block;
- each device keeps its :data:`EDIT_GRAPHS_KEPT` most recently used graphs; a new shape beyond them
  drops the least recently used one (its memory goes back before the new capture). A text loop's
  padded shapes alternate from batch to batch (WER and CER over LibriSpeech-sized batches of 64 meet
  six and change shape at about one update in three: ``chip_smoke.py`` path U0), so one kept graph
  would capture at almost every update; eight hold all of them.

Nothing outside this module clears the cache. A capture that fails raises. The eager tier
(``TM_TPU_FAST_DISPATCH=0``, the CPU) runs the same operations step by step over the whole batch,
about ten launches a prediction position, and gives the same bits: each pair's row is its own.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import resolve_device
from torchmetrics_tpu_torch.ops import dispatch

#: the rows of one block of the row scan on the graph tier (a power of two)
EDIT_BLOCK_ROWS = 64
#: the row-scan graphs each device keeps, least recently used first
EDIT_GRAPHS_KEPT = 8
#: the kept graphs of each device, by block signature and substitution cost
_GRAPHS: Dict[torch.device, "OrderedDict[Tuple, dispatch.StepGraph]"] = {}


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def levenshtein_scan(pred_ids: Tensor, pred_len: Tensor, tgt_ids: Tensor, tgt_len: Tensor,
                     substitution_cost: float) -> Tensor:
    """Distances of the padded pairs, ``(B_pad,)`` float32: the row scan, eagerly.

    ``pred_ids`` ``(B_pad, Lp)`` and ``tgt_ids`` ``(B_pad, Lt)`` are int32 ids, ``pred_len`` and
    ``tgt_len`` ``(B_pad,)`` the lengths. Reads nothing on the host, so it can be captured.
    """
    b, l_p = pred_ids.shape
    l_t = tgt_ids.shape[1]
    j = torch.arange(l_t + 1, dtype=torch.float32, device=pred_ids.device)
    row = j.expand(b, l_t + 1).clone()
    active = torch.arange(1, l_p + 1, device=pred_ids.device)[None, :] <= pred_len[:, None]  # (B_pad, Lp)
    c = torch.empty_like(row)
    cost = float(substitution_cost)
    for i in range(l_p):
        sub_cost = torch.where(pred_ids[:, i:i + 1] == tgt_ids, 0.0, cost)
        c[:, 0].fill_(float(i + 1))  # the j = 0 boundary: i + 1 deletions
        torch.minimum(row[:, :-1] + sub_cost, row[:, 1:] + 1.0, out=c[:, 1:])
        new_row = torch.cummin(c - j, dim=1).values + j
        row = torch.where(active[:, i:i + 1], new_row, row)
    return row.gather(1, tgt_len[:, None].to(torch.int64))[:, 0]


def _scan_graph(block: Tuple[Tensor, ...], substitution_cost: float, device: torch.device) -> "dispatch.StepGraph":
    """The device's row-scan graph for ``block``, loaded with it: a kept one, or a new capture that drops the
    least recently used graph first when :data:`EDIT_GRAPHS_KEPT` are kept."""
    key = (dispatch.signature(block, {}), float(substitution_cost))
    kept = _GRAPHS.setdefault(device, OrderedDict())
    step = kept.get(key)
    if step is not None:
        kept.move_to_end(key)
        step.load(block, {})
        return step
    while len(kept) >= EDIT_GRAPHS_KEPT:
        kept.popitem(last=False)
    static = tuple(a.clone() for a in block)
    step = dispatch.capture(device, lambda: (levenshtein_scan(*static, substitution_cost), {}),
                            lambda new_state: None, static, {})
    kept[key] = step
    return step


def _block_rows(x: Tensor, start: int, rows: int, pad: int) -> Tensor:
    """Rows ``start:start + rows`` of ``x``, padded with ``pad`` past its end."""
    part = x[start:start + rows]
    if part.shape[0] == rows:
        return part
    out = x.new_full((rows,) + tuple(x.shape[1:]), pad)
    out[:part.shape[0]] = part
    return out


def _graph_scan(args: Tuple[Tensor, ...], substitution_cost: float, device: torch.device) -> Tensor:
    """:func:`levenshtein_scan` on the graph tier: one replay per block of :data:`EDIT_BLOCK_ROWS` rows, the
    last block padded with empty pairs (ids -1 and -2, lengths 0)."""
    rows = EDIT_BLOCK_ROWS
    b = args[0].shape[0]
    out = torch.empty((b,), dtype=torch.float32, device=device)
    for start in range(0, b, rows):
        block = tuple(_block_rows(x, start, rows, pad) for x, pad in zip(args, (-1, 0, -2, 0)))
        step = _scan_graph(block, substitution_cost, device)
        step.replay()
        out[start:start + rows] = step.values()[:b - start]
    return out


def _intern(batch: Sequence[Sequence[Any]], vocab: dict) -> List[List[int]]:
    return [[vocab.setdefault(tok, len(vocab)) for tok in seq] for seq in batch]


def padded_ids(preds_tokens: Sequence[Sequence[Any]], target_tokens: Sequence[Sequence[Any]]
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The interned pairs as JAX pads them (``_edit.py:83-117``): ``(pred_ids, pred_len, tgt_ids,
    tgt_len)``, int32, ``B``, ``Lp`` and ``Lt`` rounded up to powers of two, pads -1 and -2."""
    vocab: dict = {}
    p_ids = _intern(preds_tokens, vocab)
    t_ids = _intern(target_tokens, vocab)
    l_p = _next_pow2(max(1, max(len(r) for r in p_ids)))
    l_t = _next_pow2(max(1, max(len(r) for r in t_ids)))
    b_pad = _next_pow2(len(p_ids))
    pp = np.full((b_pad, l_p), -1, np.int32)
    tt = np.full((b_pad, l_t), -2, np.int32)
    pl = np.zeros((b_pad,), np.int32)
    tl = np.zeros((b_pad,), np.int32)
    for i, (pr, tr) in enumerate(zip(p_ids, t_ids)):
        pp[i, : len(pr)] = pr
        tt[i, : len(tr)] = tr
        pl[i] = len(pr)
        tl[i] = len(tr)
    return pp, pl, tt, tl


def edit_distance_batch(
    preds_tokens: Sequence[Sequence[Any]],
    target_tokens: Sequence[Sequence[Any]],
    substitution_cost: float = 1.0,
    device: Union[str, torch.device, None] = None,
) -> Tensor:
    """Per-pair Levenshtein distances of a batch of token sequences, ``(B,)`` float32 on ``device``
    (CUDA unless named): one graph replay per block of rows on the graph tier, the row scan step by step
    otherwise."""
    if len(preds_tokens) != len(target_tokens):
        raise ValueError(
            f"Expected argument `preds` and `target` to have same length, but got {len(preds_tokens)} and {len(target_tokens)}"
        )
    device = resolve_device(device)
    if not preds_tokens:
        return torch.zeros((0,), dtype=torch.float32, device=device)
    b = len(preds_tokens)
    args = tuple(torch.from_numpy(a).to(device) for a in padded_ids(preds_tokens, target_tokens))
    if dispatch.fast_dispatch_enabled() and dispatch.graph_device(device):
        return _graph_scan(args, substitution_cost, device)[:b]
    return levenshtein_scan(*args, substitution_cost)[:b]


def _word_batch_stats(
    preds: Sequence[str], target: Sequence[str], tokenize: Callable[[str], Sequence[str]],
    device: Union[str, torch.device, None] = None,
) -> Tuple[Tensor, np.ndarray, np.ndarray]:
    """(distances on the device, pred lengths, target lengths) of a batch of raw strings; the
    lengths stay on the host, float32 as in JAX."""
    p_tok = [tokenize(p) for p in preds]
    t_tok = [tokenize(t) for t in target]
    d = edit_distance_batch(p_tok, t_tok, device=device)
    return d, np.asarray([len(x) for x in p_tok], np.float32), np.asarray([len(x) for x in t_tok], np.float32)
