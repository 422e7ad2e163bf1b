"""Shared clustering steps (counterpart of ``torchmetrics_tpu/functional/clustering/utils.py``).

The JAX package relabels on the host (``np.unique``) and counts the contingency table with a
one-hot matmul on the TPU's matrix unit (``utils.py:43-47``). The port relabels on the device
(``torch.unique``: the same sorted codes, one read of the device for their number) and counts the
table as K1's bincount of the fused index ``target * C + pred`` over ``R * C`` bins
(:mod:`torchmetrics_tpu_torch.ops.bincount`): exact int32 counts, which the scores cast to float32
where the JAX code computes in float32.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops import histogram


def _dtype_name(x: Tensor) -> str:
    return str(x.dtype).replace("torch.", "")


def check_cluster_labels(preds: Tensor, target: Tensor) -> None:
    """Both label tensors 1-D, of one shape, real and integral (``utils.py:24``). Float labels are
    checked on the device with one read back for both tensors."""
    if preds.dim() != 1 or target.dim() != 1:
        raise ValueError(f"`preds` and `target` must be 1d, but got {preds.dim()} and {target.dim()}.")
    if preds.shape != target.shape:
        raise ValueError(
            f"Expected `preds` and `target` to have the same shape, got {tuple(preds.shape)} and {tuple(target.shape)}."
        )
    named = (("preds", preds), ("target", target))
    for name, x in named:
        if x.numel() and x.is_complex():
            raise ValueError(f"Expected real, discrete values for `{name}` but received {_dtype_name(x)}.")
    floats = [(name, x) for name, x in named if x.numel() and x.is_floating_point()]
    if floats:
        flags = torch.stack([(x != torch.floor(x)).any() for _, x in floats]).tolist()
        for (name, x), bad in zip(floats, flags):
            if bad:
                raise ValueError(f"Expected real, discrete values for `{name}` but received {_dtype_name(x)}.")


def relabel(x: Tensor) -> Tuple[Tensor, int]:
    """Map arbitrary labels to ``0..K-1`` in sorted order (``utils.py:36``): int64 codes and ``K``."""
    uniq, inv = torch.unique(x.reshape(-1), sorted=True, return_inverse=True)
    return inv, int(uniq.numel())


def contingency_from_indices(target_idx: Tensor, preds_idx: Tensor, num_target: int, num_preds: int) -> Tensor:
    """int32 ``(R, C)`` counts of relabelled index pairs: one K1 bincount of ``target * C + pred``."""
    fused = target_idx.to(torch.int64) * num_preds + preds_idx.to(torch.int64)
    return histogram.bincount(fused, num_target * num_preds).reshape(num_target, num_preds)


def calculate_contingency_matrix(preds: Tensor, target: Tensor) -> Tensor:
    """int32 ``(n_classes_target, n_classes_preds)`` contingency matrix (``utils.py:50``); at least
    ``(1, 1)``, as in the JAX package, when there are no samples."""
    t_idx, n_t = relabel(target)
    p_idx, n_p = relabel(preds)
    return contingency_from_indices(t_idx, p_idx, max(n_t, 1), max(n_p, 1))


def calculate_entropy(x: Tensor) -> Tensor:
    """Entropy of a label tensor (``utils.py:57``): the counts of its relabelled codes by K1."""
    if x.shape[0] == 0:
        return torch.ones((), dtype=torch.float32, device=x.device)
    idx, k = relabel(x)
    if k == 1:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    p = histogram.bincount(idx, k).to(torch.float32)
    n = p.sum()
    # every code occurs after relabelling, so every count is positive and every log finite
    return -torch.sum((p / n) * (torch.log(p) - torch.log(n)))


def calculate_generalized_mean(x: Tensor, p: Union[int, float, str]) -> Tensor:
    """Generalized mean (``utils.py:70``)."""
    if isinstance(p, str):
        if p == "min":
            return torch.min(x)
        if p == "geometric":
            return torch.exp(torch.mean(torch.log(x)))
        if p == "arithmetic":
            return torch.mean(x)
        if p == "max":
            return torch.max(x)
        raise ValueError("'method' must be 'min', 'geometric', 'arirthmetic', or 'max'")
    return torch.mean(x**p) ** (1.0 / p)


def _validate_average_method_arg(average_method: str) -> None:
    if average_method not in ("min", "geometric", "arithmetic", "max"):
        raise ValueError("Expected argument `average_method` to be one of `min`, `geometric`, `arithmetic`, `max`")


def calculate_pair_cluster_confusion_matrix(
    preds: Optional[Tensor] = None, target: Optional[Tensor] = None, contingency: Optional[Tensor] = None
) -> Tensor:
    """float32 2x2 pair confusion matrix (``utils.py:90``), computed in float32 as in the JAX package,
    in the reference's layout: ``[0, 1]`` counts the pairs together in ``target`` but split in ``preds``."""
    if preds is None and target is None and contingency is None:
        raise ValueError("You must provide either `preds` and `target` or `contingency`.")
    if preds is not None and target is not None and contingency is not None:
        raise ValueError("You must provide either `preds` and `target` or `contingency`, not both.")
    if preds is not None and target is not None:
        contingency = calculate_contingency_matrix(preds, target)
    if contingency is None:
        raise ValueError("You must provide `contingency` if `preds` and `target` are not provided.")
    contingency = contingency.to(torch.float32)
    num_samples = contingency.sum()
    sum_c = contingency.sum(dim=1)
    sum_k = contingency.sum(dim=0)
    sum_squared = (contingency**2).sum()
    m11 = sum_squared - num_samples
    m10 = (contingency * sum_k[None, :]).sum() - sum_squared
    m01 = (contingency.T * sum_c[None, :]).sum() - sum_squared
    m00 = num_samples**2 - m01 - m10 - sum_squared
    return torch.stack([torch.stack([m00, m01]), torch.stack([m10, m11])])


def _validate_intrinsic_cluster_data(data: Tensor, labels: Tensor) -> None:
    """``utils.py:120``."""
    if data.dim() != 2:
        raise ValueError(f"Expected 2D data, got {data.dim()}D data instead")
    if not data.is_floating_point():
        raise ValueError("Expected floating point data, got non-floating point data instead")
    if labels.dim() != 1:
        raise ValueError(f"Expected 1D labels, got {labels.dim()}D labels instead")


def _validate_intrinsic_labels_to_samples(num_labels: int, num_samples: int) -> None:
    """``utils.py:130``."""
    if not 1 < num_labels < num_samples:
        raise ValueError(
            "Number of detected clusters must be greater than one and less than the number of samples."
            f"Got {num_labels} clusters and {num_samples} samples."
        )
