"""Pairwise distance and similarity matrices (counterpart of
``torchmetrics_tpu/functional/pairwise/distances.py``).

Cosine, euclidean and linear are one ``[N, d] x [d, M]`` matrix product each, run in full float32
whatever TF32 flags the caller set (``utils/precision.full_float32``), as the JAX package asks for
``precision="highest"`` (``distances.py:25``). Euclidean is the Gram expansion
``sqrt(max(x² + y² - 2·x@yᵀ, 0))`` in float32, clamped at 0, as in JAX (``distances.py:66``).

Manhattan and minkowski have no product form: the JAX package broadcasts ``[N, M, d]``
(``distances.py:134``, ``:175``), 51 GB at 4,096 x 4,096 x 768 in float32. The port takes the rows
of ``x`` in blocks whose broadcast holds at most :data:`BLOCK_BYTES`, with the same operations on
each element. Integer inputs keep JAX's integer results: the linear product and the manhattan
sum in the inputs' integer dtype (a broadcast product by blocks: CUDA has no integer matmul).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.pairwise.helpers import _check_input, _reduce_distance_matrix, _zero_diagonal
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError
from torchmetrics_tpu_torch.utils.precision import full_float32

#: device memory the broadcast ``[rows, M, d]`` of one block of rows may take
BLOCK_BYTES = 1 << 30


def block_rows(m: int, d: int, itemsize: int = 4) -> int:
    """Rows of ``x`` in one block of a broadcast against ``m`` rows of width ``d``."""
    return max(1, BLOCK_BYTES // max(1, m * d * itemsize))


def _by_row_blocks(x: Tensor, y: Tensor, body: Callable[[Tensor, Tensor], Tensor], dtype: torch.dtype) -> Tensor:
    """``body(x_block, y)`` for each block of rows of ``x``, written into one ``[N, M]`` result."""
    n, m = x.shape[0], y.shape[0]
    out = torch.empty((n, m), dtype=dtype, device=x.device)
    step = block_rows(m, x.shape[1], x.element_size())
    for r0 in range(0, n, step):
        out[r0:r0 + step] = body(x[r0:r0 + step], y)
    return out


def _as_jax_dtype(x: Tensor, y: Tensor, to_float: bool = False):
    """The two inputs in one dtype, as the JAX package computes them with 64-bit mode off: float64
    as float32, integers as they are (or as float32 with ``to_float``)."""
    dtype = torch.promote_types(x.dtype, y.dtype)
    if dtype == torch.float64 or (to_float and not dtype.is_floating_point):
        dtype = torch.float32
    return x.to(dtype), y.to(dtype)


def _matmul_f32(x: Tensor, yt: Tensor) -> Tensor:
    """``x @ yt`` in full float32; integers multiply and add in their own dtype."""
    if x.is_floating_point():
        with full_float32():
            return torch.matmul(x, yt)
    return _by_row_blocks(x, yt.T, lambda xb, y: torch.sum(xb[:, None, :] * y[None, :, :], dim=-1, dtype=x.dtype), x.dtype)


def _pairwise_cosine_similarity_update(x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None) -> Tensor:
    """Rows scaled to unit norm, then one product (``distances.py:31``)."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x, y = _as_jax_dtype(x, y, to_float=True)
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    y = y / torch.linalg.vector_norm(y, dim=1, keepdim=True)
    return _zero_diagonal(_matmul_f32(x, y.T), zero_diagonal)


def pairwise_cosine_similarity(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Pairwise cosine similarity ``<x,y> / (||x||·||y||)`` (``distances.py:43``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_cosine_similarity
        >>> pairwise_cosine_similarity(torch.tensor([[1.0, 0.0], [1.0, 1.0]])).round(decimals=4)
        tensor([[0.0000, 0.7071],
                [0.7071, 0.0000]])
    """
    return _reduce_distance_matrix(_pairwise_cosine_similarity_update(x, y, zero_diagonal), reduction)


def _pairwise_euclidean_distance_update(x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None) -> Tensor:
    """The Gram expansion in float32, clamped at 0 (``distances.py:66``)."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x, y = x.to(torch.float32), y.to(torch.float32)
    x_norm = torch.sum(x * x, dim=1, keepdim=True)
    y_norm = torch.sum(y * y, dim=1)
    distance = torch.clamp_min(x_norm + y_norm - 2 * _matmul_f32(x, y.T), 0.0)
    return torch.sqrt(_zero_diagonal(distance, zero_diagonal))


def pairwise_euclidean_distance(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Pairwise euclidean distance (``distances.py:84``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_euclidean_distance
        >>> pairwise_euclidean_distance(torch.tensor([[1.0, 0.0], [0.0, 1.0]])).round(decimals=4)
        tensor([[0.0000, 1.4142],
                [1.4142, 0.0000]])
    """
    return _reduce_distance_matrix(_pairwise_euclidean_distance_update(x, y, zero_diagonal), reduction)


def _pairwise_linear_similarity_update(x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None) -> Tensor:
    """The plain inner-product matrix (``distances.py:105``)."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x, y = _as_jax_dtype(x, y)
    return _zero_diagonal(_matmul_f32(x, y.T), zero_diagonal)


def pairwise_linear_similarity(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Pairwise linear (dot-product) similarity (``distances.py:114``)."""
    return _reduce_distance_matrix(_pairwise_linear_similarity_update(x, y, zero_diagonal), reduction)


def _abs_diff_sum(xb: Tensor, y: Tensor) -> Tensor:
    return torch.sum(torch.abs(xb[:, None, :] - y[None, :, :]), dim=-1, dtype=xb.dtype)


def _pairwise_manhattan_distance_update(x: Tensor, y: Optional[Tensor] = None, zero_diagonal: Optional[bool] = None) -> Tensor:
    """The broadcast ``Σ|xᵢ - yⱼ|`` by blocks of rows (``distances.py:131``)."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    x, y = _as_jax_dtype(x, y)
    return _zero_diagonal(_by_row_blocks(x, y, _abs_diff_sum, x.dtype), zero_diagonal)


def pairwise_manhattan_distance(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """Pairwise manhattan (L1) distance (``distances.py:140``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_manhattan_distance
        >>> pairwise_manhattan_distance(torch.tensor([[1.0, 0.0], [0.0, 1.0]]))
        tensor([[0., 2.],
                [2., 0.]])
    """
    return _reduce_distance_matrix(_pairwise_manhattan_distance_update(x, y, zero_diagonal), reduction)


def _pairwise_minkowski_distance_update(
    x: Tensor, y: Optional[Tensor] = None, exponent: float = 2, zero_diagonal: Optional[bool] = None
) -> Tensor:
    """The broadcast ``(Σ|xᵢ - yⱼ|^p)^(1/p)`` in float32 by blocks of rows (``distances.py:165``)."""
    x, y, zero_diagonal = _check_input(x, y, zero_diagonal)
    if not (isinstance(exponent, (float, int)) and exponent >= 1):
        raise TorchMetricsUserError(f"Argument ``p`` must be a float or int greater than 1, but got {exponent}")
    x, y = x.to(torch.float32), y.to(torch.float32)

    def body(xb: Tensor, yy: Tensor) -> Tensor:
        return torch.sum(torch.abs(xb[:, None, :] - yy[None, :, :]).pow_(exponent), dim=-1).pow_(1.0 / exponent)

    return _zero_diagonal(_by_row_blocks(x, y, body, torch.float32), zero_diagonal)


def pairwise_minkowski_distance(
    x: Tensor,
    y: Optional[Tensor] = None,
    exponent: float = 2,
    reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """Pairwise minkowski (Lᵖ) distance (``distances.py:177``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import pairwise_minkowski_distance
        >>> pairwise_minkowski_distance(torch.tensor([[1.0, 2.0], [3.0, 4.0]]), exponent=3).round(decimals=4)
        tensor([[0.0000, 2.5198],
                [2.5198, 0.0000]])
    """
    return _reduce_distance_matrix(_pairwise_minkowski_distance_update(x, y, exponent, zero_diagonal), reduction)
