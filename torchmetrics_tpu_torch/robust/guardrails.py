"""Numeric guardrails inside the update: ``Metric(nan_policy=...)`` (counterpart of
``torchmetrics_tpu/robust/guardrails.py``).

One bad batch (an overflowed loss, a division by zero upstream, a corrupted shard) can poison a
sum or a mean for good, and a host-side ``isnan`` check per batch would read the card every
step. The guard here stays on the device. When a metric opts in (``nan_policy != "propagate"``)
every dispatch tier builds its step from :func:`guarded_update`, which

- counts the non-finite values of every floating-point tensor of the batch with ``isfinite``
  into an extra ``sum``-reduced float32 state (:data:`POISON_STATE`, registered by the engine),
- and under ``nan_policy="mask"`` replaces them with ``0.0`` before the metric's own ``_update``
  sees them.

Both are ordinary tensor operations, so they run inside the step's captured graph on the graph
tier and step by step on the eager tier, with the same bits. Nothing is read on the host until
``compute()``, where the engine reads the counter once and raises, warns or reports per the policy
(``Metric._guard_poison``).

Masking substitutes ``0.0``: the identity of sums and means, but a value like any other for order
statistics (max/min) and ``cat`` states, as in the JAX package. Metrics that need identity-element
NaN handling (the aggregation metrics' ``nan_strategy``) keep their own masking; the policies
compose.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch import Tensor
from torch.utils._pytree import tree_flatten, tree_unflatten

#: name of the poison-counter state the engine registers when a policy is active
POISON_STATE = "nan_poison_total"

#: accepted ``nan_policy`` values. "propagate" (default) is a true no-op: no extra state,
#: no wrapper, no per-step cost.
POLICIES = ("propagate", "raise", "warn", "mask")


def validate_policy(policy: Any) -> str:
    if policy not in POLICIES:
        raise ValueError(f"Expected keyword argument `nan_policy` to be one of {POLICIES} but got {policy!r}")
    return policy


def scrub_nonfinite(args: tuple, kwargs: dict, mask: bool) -> Tuple[tuple, dict, Any]:
    """Count (and with ``mask`` zero out) the non-finite entries of every floating-point tensor of a batch.

    Returns ``(args, kwargs, bad)``, ``bad`` a float32 device scalar, or the float ``0.0`` when the
    batch holds no floating-point tensor. Integer, bool and complex tensors and non-tensor leaves pass
    through untouched. Reads nothing on the host, so it can be captured.
    """
    leaves, spec = tree_flatten((args, kwargs))
    bad: Any = 0.0
    out = []
    for leaf in leaves:
        if isinstance(leaf, Tensor) and leaf.is_floating_point():
            finite = torch.isfinite(leaf)
            bad = bad + torch.sum(~finite, dtype=torch.float32)
            if mask:
                leaf = torch.where(finite, leaf, leaf.new_zeros(()))
        out.append(leaf)
    args, kwargs = tree_unflatten(out, spec)
    return args, kwargs, bad


def guarded_update(update_fn: Callable, policy: str) -> Callable:
    """Wrap a metric's ``_update`` with the poison counter (and the mask, if asked).

    The wrapper keeps the contract ``(state, *batch) -> state`` and adds :data:`POISON_STATE` to the
    returned dict when the incoming state carries it (the fused forward hands in the defaults, which
    do).
    """
    do_mask = policy == "mask"

    def guarded(state: Dict[str, Any], *args: Any, **kwargs: Any) -> Dict[str, Any]:
        args, kwargs, bad = scrub_nonfinite(args, kwargs, do_mask)
        out = dict(update_fn(state, *args, **kwargs))
        prev = state.get(POISON_STATE)
        if prev is not None:
            out[POISON_STATE] = prev + bad
        return out

    return guarded
