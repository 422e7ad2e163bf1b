"""Spectral distortion index, D-lambda (counterpart of ``torchmetrics_tpu/functional/image/d_lambda.py``).

The JAX package folds every unordered band pair of an input into one batch and filters it with one
convolution (``d_lambda.py:33-40``): five planes per pair and image, about 10 GB a side at 31
bands (465 pairs) and 4 images of 512 x 512. The port takes the pairs in blocks whose planes hold
at most :data:`BLOCK_BYTES`, the pair indices made on the device (``torch.triu_indices``, the
JAX package's order), each pair's UQI the same operations as in one batch.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.image.helpers import reduce
from torchmetrics_tpu_torch.functional.image.uqi import _uqi_map

#: device memory one block of band pairs may take, and the float32 planes of one pair and image at
#: the peak (the two padded bands, the five-plane stack and its filtered moments, the map's terms)
BLOCK_BYTES = 1 << 30
PLANES_PER_PAIR = 24


def _spectral_distortion_index_check_inputs(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """``d_lambda.py:19``."""
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    if preds.ndim != 4 or target.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    if preds.shape[:2] != target.shape[:2]:
        raise ValueError(
            "Expected `preds` and `target` to have same batch and channel sizes."
            f"Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def block_pairs(batch: int, height: int, width: int) -> int:
    """Band pairs in one block of the pairwise UQI over ``batch`` images of ``height x width``."""
    per_pair = PLANES_PER_PAIR * batch * (height + 10) * (width + 10) * 4
    return max(1, BLOCK_BYTES // per_pair)


def _pairwise_band_uqi(x: Tensor, pairs: Tensor) -> Tensor:
    """Mean UQI of each band pair ``pairs[:, p]`` of ``x``, over the images and pixels (``d_lambda.py:33``)."""
    b, _, h, w = x.shape
    n_pairs = pairs.shape[1]
    out = torch.empty(n_pairs, dtype=torch.float32, device=x.device)
    step = block_pairs(b, h, w)
    for p0 in range(0, n_pairs, step):
        block = pairs[:, p0:p0 + step]
        p = block.shape[1]
        left = x.index_select(1, block[0]).transpose(0, 1).reshape(p * b, 1, h, w)
        right = x.index_select(1, block[1]).transpose(0, 1).reshape(p * b, 1, h, w)
        out[p0:p0 + p] = torch.mean(_uqi_map(left, right).reshape(p, -1), dim=1)
    return out


def _spectral_distortion_index_compute(preds: Tensor, target: Tensor, p: int = 1, reduction: str = "elementwise_mean") -> Tensor:
    """``d_lambda.py:44``: one band gives 0, as both matrices are empty (``d_lambda.py:49-51``)."""
    length = preds.shape[1]
    if length == 1:
        return reduce(torch.zeros((), dtype=torch.float32, device=preds.device), reduction)
    pairs = torch.triu_indices(length, length, offset=1, device=preds.device)
    m1_vals = _pairwise_band_uqi(target, pairs)
    m2_vals = _pairwise_band_uqi(preds, pairs)
    diff = torch.abs(m1_vals - m2_vals) ** p
    # each unordered pair appears twice in the symmetric matrices (``d_lambda.py:58``)
    output = (2 * torch.sum(diff) / (length * (length - 1))) ** (1.0 / p)
    return reduce(output, reduction)


def spectral_distortion_index(preds: Tensor, target: Tensor, p: int = 1, reduction: str = "elementwise_mean") -> Tensor:
    """D-lambda (``d_lambda.py:63``)."""
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"`p` must be a positive integer. Got p: {p}.")
    preds, target = _spectral_distortion_index_check_inputs(preds, target)
    return _spectral_distortion_index_compute(preds, target, p, reduction)
