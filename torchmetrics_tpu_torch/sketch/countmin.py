"""Count-min sketch over integer ids: a fixed ``(depth, width)`` float32 state, merged by sum
(counterpart of ``torchmetrics_tpu/sketch/countmin.py``).

Retrieval's ``approx="sketch"`` mode counts query ids with it, so that a query whose documents
straddle an update batch is detected without storing any id; it also answers approximate frequency
queries over any integer stream.

- :func:`cm_query` never underestimates a true count; the overestimate is at most ``e·n/width``
  with probability ``1 - e^-depth`` per query (``n`` the total weight added).
- The hash of row ``d`` is the JAX package's multiplicative hash in uint32 arithmetic:
  ``h = id * mult_d + 0x9E3779B9·(d + 1) mod 2^32``, bucket ``(h >> 16) % width``. Torch has no
  usable uint32 multiply, and an int64 product of two 32-bit values overflows, so the port takes the
  low 32 bits of the id (the bits of the JAX package's int32 wrap and uint32 cast) and multiplies by
  the 16-bit halves of the constant, every intermediate below 2^50 (:func:`_mul32`).
- An update is one K1 launch (``ops.histogram.bincount``) over the fused index ``d·width + h_d``
  into ``depth·width`` bins, where the JAX package makes ``depth`` bincounts; the counts are the
  same. Unit weights (``weights=None``) and bool weights (a mask, as retrieval's ``is_new``) take
  K1, which drops the masked elements sent out of range, and the int32 counts are added as float32:
  the state is bit-equal to the JAX package's below 2^24 a cell. Float weights take K2's weighted
  bincount, one launch over the same fused index.
- Merge is an elementwise sum: the state registers with ``dist_reduce_fx="sum"``.

No operation reads the device from the host, so an update may run inside a captured CUDA graph.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops import histogram as _histogram

DEFAULT_DEPTH = 4
DEFAULT_WIDTH = 1024

#: fixed odd 32-bit multiplicative-hash constants, one per row, as in the JAX package
_HASH_MULTIPLIERS = (2654435761, 2246822519, 3266489917, 668265263, 374761393, 2654435769, 3141592653, 2718281829)
_MASK32 = 0xFFFFFFFF


def cm_init(depth: int = DEFAULT_DEPTH, width: int = DEFAULT_WIDTH) -> Tensor:
    """Empty sketch: ``(depth, width)`` float32 zeros (the sum identity)."""
    if not (1 <= depth <= len(_HASH_MULTIPLIERS)):
        raise ValueError(f"countmin depth must be in [1, {len(_HASH_MULTIPLIERS)}], got {depth}")
    if width < 2:
        raise ValueError(f"countmin width must be >= 2, got {width}")
    return torch.zeros((depth, width), dtype=torch.float32)


def _mul32(a: Tensor, m: int) -> Tensor:
    """``a * m mod 2^32`` for int64 ``a`` in ``[0, 2^32)`` and a 32-bit constant ``m``, by the 16-bit
    halves of ``m``: ``a·m_lo + ((a·m_hi) mod 2^16)·2^16``, each term below 2^49."""
    return (a * (m & 0xFFFF) + (((a * (m >> 16)) & 0xFFFF) << 16)) & _MASK32


def _hash_rows(ids: Tensor, depth: int, width: int) -> Tensor:
    """``(depth, N)`` int64 bucket indices in ``[0, width)``, the JAX package's ``_hash_rows``."""
    ids_u = ids.reshape(-1).to(torch.int64) & _MASK32
    rows = []
    for d in range(depth):
        h = (_mul32(ids_u, _HASH_MULTIPLIERS[d]) + (0x9E3779B9 * (d + 1) & _MASK32)) & _MASK32
        rows.append(torch.remainder(h >> 16, width))
    return torch.stack(rows)


def _fused(hashed: Tensor, width: int) -> Tensor:
    """The flat index ``d·width + h_d`` of each row's bucket, ``(depth·N,)``."""
    depth = hashed.shape[0]
    offsets = torch.arange(depth, dtype=hashed.dtype, device=hashed.device)[:, None] * width
    return (hashed + offsets).reshape(-1)


def cm_update(state: Tensor, ids: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """``state`` with ``weights`` (default 1) added per id; pure, with one kernel launch.

    ``weights`` of dtype bool is a mask: the ids where it is False are not counted (K1). Other
    weights are float sums (K2), as in the JAX package.
    """
    depth, width = state.shape
    fused = _fused(_hash_rows(ids, depth, width), width)
    if weights is None or weights.dtype == torch.bool:
        if weights is not None:  # masked ids go out of range, where K1 drops them
            fused = torch.where(weights.reshape(-1).repeat(depth), fused, -1)
        counts = _histogram.bincount(fused, depth * width)
    else:
        counts = _histogram.bincount_weighted(fused, depth * width, weights.reshape(-1).repeat(depth), torch.float32)
    return state + counts.to(torch.float32).reshape(depth, width)


def cm_query(state: Tensor, ids: Tensor) -> Tensor:
    """Estimated counts for ``ids``: the least of the ``depth`` cells, never below the true count."""
    depth, width = state.shape
    hashed = _hash_rows(ids, depth, width)
    return state.reshape(-1)[_fused(hashed, width)].reshape(depth, -1).amin(0)


def cm_error_bound(width: int = DEFAULT_WIDTH) -> float:
    """Documented per-query overestimate bound as a fraction of the total stream weight."""
    return 2.718281828 / width


def cm_state_bytes(depth: int = DEFAULT_DEPTH, width: int = DEFAULT_WIDTH) -> int:
    """Fixed state footprint in bytes (float32), independent of the ids seen."""
    return depth * width * 4
