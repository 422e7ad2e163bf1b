"""KLL-style compactor quantile sketch: a fixed-shape, mergeable state (counterpart of
``torchmetrics_tpu/sketch/kll.py``).

The state is one ``(levels, capacity + 2)`` float32 tensor (about 12 KB at the defaults), where an
exact quantile would keep every sample:

- level ``l`` holds up to ``capacity`` items, each standing for ``2^l`` samples, ascending with
  ``+inf`` padding; column ``capacity`` is the level's valid count and column ``capacity + 1`` its
  compaction parity bit;
- compaction sorts a level and promotes every other item, from an offset that alternates with the
  parity bit, to the level above; an odd leftover (the largest item) stays, so the weight is kept
  exactly and :func:`kll_count` is the true sample count;
- a batch is pre-compacted into per-level fragments by slicing (:func:`_bulk_fragments`), then one
  bottom-up sweep folds fragments and carry into the state (:func:`_sweep`).

Every data-dependent decision ("is the level full?") is a ``torch.where`` over fixed shapes, as
the JAX package's ``jnp.where``: no value is read back to the host, so an update may run inside a
captured CUDA graph, under ``torch.func.vmap`` (the keyed engine's ``vmap`` strategy) and on both
dispatch tiers alike. The operations are sorts, selects and gathers of float32 values with whole
counts, so the state equals the JAX package's bit for bit: ``torch.sort`` and ``jnp.sort`` both
keep ties (``-0.0`` and ``+0.0`` too) in input order and put NaN after ``+inf`` on the CPU. On the
card ``torch.sort`` may order ``-0.0`` before ``+0.0``; no other value moves.

Merge is weight-exact and commutative bit for bit: both operands' rows enter one sort and the
parities combine by XOR. It is associative only within the error bound. At the default capacity of
128 the rank error is at most ``DEFAULT_RANK_ERROR·n`` for ``n <= 2^24``.

The sweep runs some 36 small operations on each of its ``levels`` levels: eager, an update at the
defaults is about 890 operations; on the graph tier it is one replay. The gathers are
``torch.gather``, whose vmap rule is a batched gather, where an indexing ``tensor[index]`` by a
batched index is many times slower under ``torch.func.vmap``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

#: default per-level buffer width; the error is ~ O(log^2(n/cap)/cap)
DEFAULT_CAPACITY = 128
#: default level count: capacity·2^(levels-1) ≈ 2^31 samples before the top level could overflow
DEFAULT_LEVELS = 24
#: documented rank-error bound at the default capacity
DEFAULT_RANK_ERROR = 0.02

_INF = float("inf")


def kll_init(capacity: int = DEFAULT_CAPACITY, levels: int = DEFAULT_LEVELS) -> Tensor:
    """Empty sketch: ``(levels, capacity + 2)`` float32, items ``+inf``, counts and parities 0.

    The empty sketch is the merge identity, so it is also the ``add_state`` default.
    """
    if capacity < 8 or capacity % 2:
        raise ValueError(f"kll capacity must be an even integer >= 8, got {capacity}")
    if levels < 2:
        raise ValueError(f"kll levels must be >= 2, got {levels}")
    state = torch.full((levels, capacity + 2), _INF, dtype=torch.float32)
    state[:, capacity:] = 0.0
    return state


def _split(state: Tensor) -> Tuple[Tensor, Tensor, Tensor, int]:
    cap = state.shape[-1] - 2
    return state[:, :cap], state[:, cap], state[:, cap + 1], cap


def _level_weights(state: Tensor) -> Tensor:
    return torch.pow(2.0, torch.arange(state.shape[0], dtype=torch.float32, device=state.device))


def kll_count(state: Tensor) -> Tensor:
    """Total weighted sample count, exact: compaction conserves weight."""
    _items, counts, _par, _cap = _split(state)
    return torch.sum(counts * _level_weights(state))


def _bulk_fragments(values: Tensor, capacity: int) -> List[Tuple[int, Tensor]]:
    """Pre-compact a batch into per-level fragments ``[(level, ascending items), ...]``, every size
    static: the sorted batch is halved (alternating offset) until it fits one level; an odd leftover
    parks one item at its level. This is a run of in-order compactions."""
    arr = torch.sort(values.to(torch.float32).reshape(-1), stable=True).values
    frags = []
    lvl, parity = 0, 0
    while arr.shape[0] > capacity:
        if arr.shape[0] % 2:
            frags.append((lvl, arr[-1:]))  # odd leftover stays at this level
            arr = arr[:-1]
        arr = arr[parity::2]
        parity = 1 - parity
        lvl += 1
    frags.append((lvl, arr))
    return frags


def _sweep(state: Tensor, fragments: Sequence[Tuple[int, Tensor, Union[Tensor, float], Union[Tensor, float]]]) -> Tensor:
    """One bottom-up pass folding per-level fragments into the state with a carry.

    ``fragments``: per level, ``(level, items, count, parity)``, items ``+inf``-padded to any
    static width, ``count`` the valid leading items (a tensor or a number), ``parity`` the
    fragment's compaction parity (added mod 2, which keeps merge commutative). A level sees at most
    ``cap`` own + ``2·cap`` carry + ``cap`` fragment items and promotes at most half of them, so a
    carry of ``2·cap`` suffices.
    """
    items, counts, parities, cap = _split(state)
    levels = state.shape[0]
    device = state.device
    by_level: dict = {}
    for lvl, arr, cnt, par in fragments:
        by_level.setdefault(lvl, []).append((arr, cnt, par))
    ramp_i = torch.arange(2 * cap, dtype=torch.int64, device=device)
    ramp_f = ramp_i.to(torch.float32)
    inf_carry = torch.full((2 * cap,), _INF, dtype=torch.float32, device=device)
    inf_tail = torch.full((cap - 1,), _INF, dtype=torch.float32, device=device)
    carry = inf_carry
    carry_cnt = torch.zeros((), dtype=torch.float32, device=device)
    out_rows, out_counts, out_pars = [], [], []
    for lvl in range(levels):
        row, cnt, par = items[lvl], counts[lvl], parities[lvl]
        pieces = [row, carry]
        v = cnt + carry_cnt
        for arr, fcnt, fpar in by_level.get(lvl, ()):
            pieces.append(arr)
            v = v + fcnt
            par = torch.remainder(par + fpar, 2.0)
        work = torch.sort(torch.cat(pieces), stable=True).values  # valid items first, +inf padding last
        w = work.shape[0]
        compact = v > cap
        m = torch.floor(v / 2.0)  # pairs compacted; v - 2m (0 or 1) items stay behind
        # promoted: among the first 2m valid items, every other one starting at the parity
        pick = par.to(torch.int64) + 2 * ramp_i
        promoted = torch.where(ramp_f < m, torch.gather(work, 0, torch.clamp(pick, 0, w - 1)), _INF)
        # leftover (v odd): the largest valid item stays at this level
        last = torch.clamp(v, 1, w).to(torch.int64) - 1
        leftover = torch.where(torch.remainder(v, 2.0) > 0, torch.gather(work, 0, last.reshape(1))[0], _INF)
        compacted_row = torch.cat([leftover.reshape(1), inf_tail])
        out_rows.append(torch.where(compact, compacted_row, work[:cap]))
        out_counts.append(torch.where(compact, torch.remainder(v, 2.0), v))
        out_pars.append(torch.where(compact, torch.remainder(par + 1.0, 2.0), par))
        carry = torch.where(compact, torch.sort(promoted, stable=True).values, inf_carry)
        carry_cnt = torch.where(compact, m, 0.0)
    # a carry out of the top level is unreachable below capacity·2^(levels-1) samples and is dropped
    return torch.cat([torch.stack(out_rows), torch.stack(out_counts)[:, None], torch.stack(out_pars)[:, None]], dim=1)


def kll_update(state: Tensor, values: Tensor) -> Tensor:
    """Fold a batch of values into the sketch. Pure; capturable and vmappable."""
    _items, _counts, _par, cap = _split(state)
    frags = [(lvl, arr, float(arr.shape[0]), 0.0) for lvl, arr in _bulk_fragments(values, cap)]
    return _sweep(state, frags)


def kll_merge(a: Tensor, b: Tensor) -> Tensor:
    """Merge two sketches of one shape: weight-exact and commutative bit for bit."""
    if a.shape != b.shape:
        raise ValueError(f"cannot merge KLL sketches of shapes {tuple(a.shape)} and {tuple(b.shape)}")
    items_b, counts_b, pars_b, _cap = _split(b)
    return _sweep(a, [(lvl, items_b[lvl], counts_b[lvl], pars_b[lvl]) for lvl in range(b.shape[0])])


def kll_merge_stacked(stacked: Tensor) -> Tensor:
    """Fold ``(k, levels, capacity + 2)`` stacked sketches into one, in order: the callable
    ``dist_reduce_fx`` shape (the forward's merge ladder stacks two; sync stacks the world in rank
    order)."""
    out = stacked[0]
    for i in range(1, stacked.shape[0]):
        out = kll_merge(out, stacked[i])
    return out


# the fused forward takes a callable reduction only when it is declared capturable (pure tensor
# operations over the stacked states), as the JAX package's ``traceable`` flag declares it
kll_merge_stacked.traceable = True


def _weighted_points(state: Tensor) -> Tuple[Tensor, Tensor]:
    """(sorted item values, per-item weights) over the whole sketch; invalid slots carry weight 0
    and sort last (``+inf``)."""
    items, counts, _par, cap = _split(state)
    valid = torch.arange(cap, dtype=torch.float32, device=state.device)[None, :] < counts[:, None]
    flat = items.reshape(-1)
    weights = torch.where(valid, _level_weights(state)[:, None], 0.0).reshape(-1)
    order = torch.sort(flat, stable=True).indices
    return torch.gather(flat, 0, order), torch.gather(weights, 0, order)


def kll_weighted_points(state: Tensor) -> Tuple[Tensor, Tensor]:
    """The sketch's support as (sorted values, per-item weights); invalid slots carry weight 0 and
    sort last (``+inf``), so cumulative-weight rank queries can ignore them."""
    return _weighted_points(state)


def kll_quantiles(state: Tensor, qs) -> Tensor:
    """Estimated quantile values at probabilities ``qs`` (any shape), NaN when empty."""
    qs = torch.as_tensor(qs, dtype=torch.float32, device=state.device)
    values, weights = _weighted_points(state)
    cw = torch.cumsum(weights, 0)
    n = cw[-1]
    target = torch.clamp(qs, 0.0, 1.0) * n
    idx = torch.clamp(torch.searchsorted(cw, target.reshape(-1), side="left"), 0, values.shape[0] - 1)
    return torch.where(n > 0, torch.gather(values, 0, idx), float("nan")).reshape(qs.shape)


def kll_cdf(state: Tensor, xs) -> Tensor:
    """Estimated CDF at ``xs``: the fraction of the stream's weight with value ``<= x``."""
    xs = torch.as_tensor(xs, dtype=torch.float32, device=state.device)
    values, weights = _weighted_points(state)
    cw = torch.cat([torch.zeros(1, dtype=torch.float32, device=state.device), torch.cumsum(weights, 0)])
    n = cw[-1]
    idx = torch.searchsorted(values, xs.reshape(-1), side="right")
    return torch.where(n > 0, torch.gather(cw, 0, idx) / torch.clamp_min(n, 1.0), float("nan")).reshape(xs.shape)


def kll_ks_distance(a: Tensor, b: Tensor) -> Tensor:
    """Kolmogorov-Smirnov distance between two sketched distributions, both CDFs evaluated on the
    union of the two supports; NaN when either sketch is empty."""
    support = torch.sort(torch.cat([a[:, :-2].reshape(-1), b[:, :-2].reshape(-1)]), stable=True).values
    # +inf padding slots give cdf 1 - 1 = 0 on both sides; NaN (an empty sketch) propagates
    return torch.max(torch.abs(kll_cdf(a, support) - kll_cdf(b, support)))


def kll_psi(a: Tensor, b: Tensor, bins: int = 10) -> Tensor:
    """Population Stability Index of sketch ``b`` against the reference sketch ``a``: bin edges at
    ``a``'s quantile grid, per-bin masses from both CDFs, clamped at 1e-6."""
    # the interior of ``jnp.linspace(0, 1, bins + 1)`` in float32, bit for bit (``k·float32(1/bins)``);
    # ``torch.linspace`` differs from it in the last bit at some ``bins``
    qs = torch.from_numpy(np.arange(1, bins, dtype=np.float32) * np.float32(1.0 / bins)).to(a.device)
    edges = kll_quantiles(a, qs)
    zero, one = (torch.full((1,), x, dtype=torch.float32, device=a.device) for x in (0.0, 1.0))
    pa = torch.clamp_min(torch.diff(kll_cdf(a, edges), prepend=zero, append=one), 1e-6)
    pb = torch.clamp_min(torch.diff(kll_cdf(b, edges), prepend=zero, append=one), 1e-6)
    return torch.sum((pb - pa) * torch.log(pb / pa))


def kll_state_bytes(capacity: int = DEFAULT_CAPACITY, levels: int = DEFAULT_LEVELS) -> int:
    """Fixed state footprint in bytes (float32), independent of the samples seen."""
    return levels * (capacity + 2) * 4
