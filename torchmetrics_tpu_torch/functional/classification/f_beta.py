"""F-beta and F1 (counterpart of ``torchmetrics_tpu/functional/classification/f_beta.py``):
``_fbeta_reduce`` (``:15``) and the multiclass entry points."""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification._counts import multiclass_counts
from torchmetrics_tpu_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide


def _fbeta_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    beta: float,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
) -> Tensor:
    beta2 = beta**2
    if average == "binary":
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp)
    if average == "micro":
        dim = 0 if multidim_average == "global" else 1
        tp = torch.sum(tp, dim=dim)
        fn = torch.sum(fn, dim=dim)
        fp = torch.sum(fp, dim=dim)
        return _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp)
    fbeta_score = _safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp)
    return _adjust_weights_safe_divide(fbeta_score, average, multilabel, tp, fp, fn, top_k)


def _validate_beta(beta: float) -> None:
    if not (isinstance(beta, float) and beta > 0):
        raise ValueError(f"Argument `beta` must be a float larger than 0, but got {beta}.")


def multiclass_fbeta_score(preds, target, beta: float, num_classes: int, average: Optional[str] = "macro",
                           top_k: int = 1, multidim_average: str = "global", ignore_index: Optional[int] = None,
                           validate_args: bool = True) -> Tensor:
    """Reference ``f_beta.py:157``."""
    if validate_args:
        _validate_beta(beta)
    tp, fp, tn, fn = multiclass_counts(preds, target, num_classes, average, top_k, multidim_average,
                                       ignore_index, validate_args)
    return _fbeta_reduce(tp, fp, tn, fn, beta, average, multidim_average, top_k=top_k)


def multiclass_f1_score(preds, target, num_classes: int, average: Optional[str] = "macro", top_k: int = 1,
                        multidim_average: str = "global", ignore_index: Optional[int] = None,
                        validate_args: bool = True) -> Tensor:
    """Reference ``f_beta.py:403``."""
    return multiclass_fbeta_score(preds, target, 1.0, num_classes, average, top_k, multidim_average,
                                  ignore_index, validate_args)
