"""Tweedie deviance score (counterpart of ``torchmetrics_tpu/functional/regression/tweedie_deviance.py``).

``_domain_check`` reads the device from the host, so it runs outside any captured step: in the
functional entry, and in ``TweedieDevianceScore._validate``. The JAX package skips it under trace,
so its jitted module accepts inputs out of the domain; the port raises in both (ROADMAP queue C).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.utils import _as_float, _check_same_shape, _num_obs
from torchmetrics_tpu_torch.utils.compute import _safe_xlogy


def _check_power(power: float) -> None:
    if 0 < power < 1:
        raise ValueError(f"Deviance Score is not defined for power={power}.")


def _domain_check(preds: Tensor, target: Tensor, power: float) -> None:
    """The domain of each ``power`` (``tweedie_deviance.py:14``), with one read of the device."""
    _check_power(power)
    if power < 0:
        if bool(torch.any(preds <= 0)):
            raise ValueError(f"For power={power}, 'preds' has to be strictly positive.")
    elif 1 <= power < 2:
        if bool(torch.any(target < 0) | torch.any(preds <= 0)):
            raise ValueError(f"For power={power}, 'preds' must be strictly positive and 'targets' cannot be negative.")
    elif power >= 2:
        if bool(torch.any(target <= 0) | torch.any(preds <= 0)):
            raise ValueError(f"For power={power}, both 'preds' and 'targets' must be strictly positive.")


def _tweedie_deviance_score_update(preds: Tensor, target: Tensor, power: float = 0.0) -> Tuple[Tensor, Tensor]:
    """(Σ deviance, n) (``tweedie_deviance.py:34``), a branch per static ``power``."""
    preds, target = _as_float(preds, target)
    if power < 0:  # extreme stable distribution
        deviance_score = 2 * (
            torch.pow(torch.clamp_min(target, 0), 2 - power) / ((1 - power) * (2 - power))
            - target * torch.pow(preds, 1 - power) / (1 - power)
            + torch.pow(preds, 2 - power) / (2 - power)
        )
    elif power == 0:
        deviance_score = torch.pow(target - preds, 2)
    elif power == 1:
        deviance_score = 2 * (_safe_xlogy(target, target / preds) - target + preds)
    elif power == 2:
        deviance_score = 2 * (torch.log(preds / target) + target / preds - 1)
    elif (1 < power < 2) or power > 2:
        deviance_score = 2 * (
            torch.pow(target, 2 - power) / ((1 - power) * (2 - power))
            - target * torch.pow(preds, 1 - power) / (1 - power)
            + torch.pow(preds, 2 - power) / (2 - power)
        )
    else:
        raise ValueError(f"Deviance Score is not defined for power={power}.")
    return torch.sum(deviance_score), _num_obs(target.numel(), target)


def _tweedie_deviance_score_compute(sum_deviance_score: Tensor, num_observations: Tensor) -> Tensor:
    return sum_deviance_score / num_observations


def tweedie_deviance_score(preds: Tensor, targets: Tensor, power: float = 0.0) -> Tensor:
    """Tweedie deviance score (``tweedie_deviance.py:67``; the second argument is ``targets``, as in
    the reference).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import tweedie_deviance_score
        >>> preds, targets = torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.5, 2.5, 4.0])
        >>> print(f"{float(tweedie_deviance_score(preds, targets, power=1.5)):.4f}")
        0.1489
    """
    _check_same_shape(preds, targets)
    _domain_check(preds, targets, power)
    return _tweedie_deviance_score_compute(*_tweedie_deviance_score_update(preds, targets, power))
