"""Rank-gated warnings and logging (counterpart of ``torchmetrics_tpu/utils/prints.py``).

The rank comes from the usual launcher environment variables, or from
``torch.distributed`` once a process group is up.
"""
from __future__ import annotations

import logging
import os
import warnings
from functools import wraps
from typing import Any, Callable

import torch

log = logging.getLogger("torchmetrics_tpu_torch")


def reset_warning_cache() -> None:
    """A no-op kept for JAX's name (``prints.py:24``). The JAX package fires each (message, category) pair at
    most once per process and clears that memo here; the port keeps its "one-shot warnings" difference
    (ROADMAP.md, "Differences the port keeps on purpose"): it keeps no memo, every warning fires each time, so
    there is nothing to clear."""


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


@rank_zero_only
def rank_zero_info(message: str, **kwargs: Any) -> None:
    log.info(message, **kwargs)


@rank_zero_only
def rank_zero_debug(message: str, **kwargs: Any) -> None:
    log.debug(message, **kwargs)
