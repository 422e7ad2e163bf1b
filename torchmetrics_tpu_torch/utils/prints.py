"""Rank-gated warnings (counterpart of ``torchmetrics_tpu/utils/prints.py``).

The rank comes from the usual launcher environment variables, or from
``torch.distributed`` once a process group is up.
"""
from __future__ import annotations

import os
import warnings
from functools import wraps
from typing import Any, Callable

import torch


def _get_rank() -> int:
    for env in ("LOCAL_RANK", "RANK"):
        if env in os.environ:
            try:
                return int(os.environ[env])
            except ValueError:
                pass
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Run ``fn`` only on process 0."""

    @wraps(fn)
    def wrapped_fn(*args: Any, **kwargs: Any) -> Any:
        if _get_rank() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped_fn


@rank_zero_only
def rank_zero_warn(message: str, category: type = UserWarning, stacklevel: int = 5, **kwargs: Any) -> None:
    warnings.warn(message, category=category, stacklevel=stacklevel, **kwargs)
