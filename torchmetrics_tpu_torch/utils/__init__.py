"""Shared helpers of the PyTorch port (counterpart of ``torchmetrics_tpu/utils``, reference
``src/torchmetrics/utilities/__init__.py``), with the JAX package's 23 public names."""
from torchmetrics_tpu_torch.utils.checks import _check_same_shape, is_traced
from torchmetrics_tpu_torch.utils.compute import _safe_divide, _safe_xlogy, auc, interp
from torchmetrics_tpu_torch.utils.data import (
    _bincount,
    _cumsum,
    _flexible_bincount,
    allclose,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    select_topk,
    to_categorical,
    to_onehot,
)
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError, TorchMetricsUserWarning
from torchmetrics_tpu_torch.utils.prints import rank_zero_debug, rank_zero_info, rank_zero_warn

__all__ = [
    "_check_same_shape",
    "is_traced",
    "_safe_divide",
    "_safe_xlogy",
    "auc",
    "interp",
    "_bincount",
    "_cumsum",
    "_flexible_bincount",
    "allclose",
    "dim_zero_cat",
    "dim_zero_max",
    "dim_zero_mean",
    "dim_zero_min",
    "dim_zero_sum",
    "select_topk",
    "to_categorical",
    "to_onehot",
    "TorchMetricsUserError",
    "TorchMetricsUserWarning",
    "rank_zero_debug",
    "rank_zero_info",
    "rank_zero_warn",
]
