"""F-beta and F1 (counterpart of ``torchmetrics_tpu/functional/classification/f_beta.py``):
``_fbeta_reduce`` (``:15``), the binary, multiclass and multilabel entries (``:44-120``) and the task
entries ``fbeta_score`` and ``f1_score`` (``:123-161``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.classification._counts import binary_counts, multiclass_counts, multilabel_counts
from torchmetrics_tpu_torch.functional.classification.stat_scores import _check_task
from torchmetrics_tpu_torch.utils.compute import _adjust_weights_safe_divide, _safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask


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


def binary_fbeta_score(preds, target, beta: float, threshold: float = 0.5, multidim_average: str = "global",
                       ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Reference ``f_beta.py:84``."""
    if validate_args:
        _validate_beta(beta)
    tp, fp, tn, fn = binary_counts(preds, target, threshold, multidim_average, ignore_index, validate_args)
    return _fbeta_reduce(tp, fp, tn, fn, beta, "binary", multidim_average)


def multiclass_fbeta_score(preds, target, beta: float, num_classes: int, average: Optional[str] = "macro",
                           top_k: int = 1, multidim_average: str = "global", ignore_index: Optional[int] = None,
                           validate_args: bool = True) -> Tensor:
    """Reference ``f_beta.py:157``."""
    if validate_args:
        _validate_beta(beta)
    tp, fp, tn, fn = multiclass_counts(preds, target, num_classes, average, top_k, multidim_average,
                                       ignore_index, validate_args)
    return _fbeta_reduce(tp, fp, tn, fn, beta, average, multidim_average, top_k=top_k)


def multilabel_fbeta_score(preds, target, beta: float, num_labels: int, threshold: float = 0.5,
                           average: Optional[str] = "macro", multidim_average: str = "global",
                           ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Reference ``f_beta.py:247``."""
    if validate_args:
        _validate_beta(beta)
    tp, fp, tn, fn = multilabel_counts(preds, target, num_labels, threshold, average, multidim_average,
                                       ignore_index, validate_args)
    return _fbeta_reduce(tp, fp, tn, fn, beta, average, multidim_average, multilabel=True)


def binary_f1_score(preds, target, threshold: float = 0.5, multidim_average: str = "global",
                    ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Reference ``f_beta.py:337``."""
    return binary_fbeta_score(preds, target, 1.0, threshold, multidim_average, ignore_index, validate_args)


def multiclass_f1_score(preds, target, num_classes: int, average: Optional[str] = "macro", top_k: int = 1,
                        multidim_average: str = "global", ignore_index: Optional[int] = None,
                        validate_args: bool = True) -> Tensor:
    """Reference ``f_beta.py:403``."""
    return multiclass_fbeta_score(preds, target, 1.0, num_classes, average, top_k, multidim_average,
                                  ignore_index, validate_args)


def multilabel_f1_score(preds, target, num_labels: int, threshold: float = 0.5, average: Optional[str] = "macro",
                        multidim_average: str = "global", ignore_index: Optional[int] = None,
                        validate_args: bool = True) -> Tensor:
    """Reference ``f_beta.py:486``."""
    return multilabel_fbeta_score(preds, target, 1.0, num_labels, threshold, average, multidim_average,
                                  ignore_index, validate_args)


def fbeta_score(preds, target, task: str, beta: float = 1.0, threshold: float = 0.5,
                num_classes: Optional[int] = None, num_labels: Optional[int] = None,
                average: Optional[str] = "micro", multidim_average: str = "global", top_k: int = 1,
                ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Task-dispatching F-beta (reference ``f_beta.py:1026``)."""
    task = _check_task(task, num_classes, num_labels, top_k)
    if task == ClassificationTask.BINARY:
        return binary_fbeta_score(preds, target, beta, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        return multiclass_fbeta_score(preds, target, beta, num_classes, average, top_k, multidim_average,
                                      ignore_index, validate_args)
    return multilabel_fbeta_score(preds, target, beta, num_labels, threshold, average, multidim_average,
                                  ignore_index, validate_args)


def f1_score(preds, target, task: str, threshold: float = 0.5, num_classes: Optional[int] = None,
             num_labels: Optional[int] = None, average: Optional[str] = "micro", multidim_average: str = "global",
             top_k: int = 1, ignore_index: Optional[int] = None, validate_args: bool = True) -> Tensor:
    """Task-dispatching F1 (reference ``f_beta.py:1090``)."""
    return fbeta_score(preds, target, task, 1.0, threshold, num_classes, num_labels, average,
                       multidim_average, top_k, ignore_index, validate_args)
