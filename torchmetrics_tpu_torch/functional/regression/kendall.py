"""Kendall rank correlation (counterpart of ``torchmetrics_tpu/functional/regression/kendall.py``):
tau-a, tau-b and tau-c, and the asymptotic p-value with its tie corrections.

The JAX package compares all pairs at once, in ``(N, N)`` float32 differences, signs and masks
(``kendall.py:21-39``): several GB at N = 20,000. The port counts the pairs ``i < j`` by blocks of
rows, each block against the columns from its first row on, with a block size that keeps a
block's temporaries near 1 GiB whatever N is. Each pair is classed by the signs of its two
differences as JAX classes it, with ``jnp.sign``'s NaN: ``torch.sign(nan)`` is 0, so the sign here
keeps a NaN difference (a NaN entry, or ``inf - inf``) as NaN, which counts as neither concordant,
discordant nor a tie in its own coordinate. The counts are int64 sums, so they cannot wrap where
JAX's int32 sums of the masks do (above N = 65,536), and are cast to float32 before the
arithmetic, in JAX's order. Tie groups come from ``spearman._tie_groups``: no read of the device.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.regression.spearman import _tie_groups
from torchmetrics_tpu_torch.functional.regression.utils import _check_data_shape_to_num_outputs, _num_obs

_ALLOWED_VARIANTS = ("a", "b", "c")
_ALTERNATIVES = ("two-sided", "less", "greater")
#: device memory a block of pairs may take, and what one pair takes there at the peak (two float32
#: signs and their product, the triangle mask, and the temporaries of one sign)
BLOCK_BYTES = 1 << 30
BYTES_PER_PAIR = 32


def _check_kendall_args(variant: str, t_test: bool, alternative: Optional[str]) -> None:
    if variant not in _ALLOWED_VARIANTS:
        raise ValueError(f"Argument `variant` is expected to be one of {_ALLOWED_VARIANTS}, but got {variant}")
    if not isinstance(t_test, bool):
        raise ValueError(f"Argument `t_test` must be of a type `bool`, but got {t_test}.")
    if t_test and alternative not in _ALTERNATIVES:
        raise ValueError("Argument `alternative` is expected to be one of 'two-sided', 'less' or 'greater'.")


def _sign(d: Tensor) -> Tensor:
    """``jnp.sign``: -1, 0 or 1, and NaN for NaN."""
    return torch.where(torch.isnan(d), d, torch.sign(d))


def block_rows(n: int) -> int:
    """Rows of one block of the pair count at N = ``n``."""
    return max(1, min(n, BLOCK_BYTES // (BYTES_PER_PAIR * max(n, 1))))


def _pair_counts(x: Tensor, y: Tensor) -> Tensor:
    """int64 ``[concordant, discordant, ties in x only, ties in y only]`` over the pairs ``i < j``
    of two ``(N,)`` float32 tensors (``kendall.py:21``)."""
    n = x.shape[0]
    counts = torch.zeros(4, dtype=torch.int64, device=x.device)
    step = block_rows(n)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        sx = _sign(x[r0:r1, None] - x[None, r0:])
        sy = _sign(y[r0:r1, None] - y[None, r0:])
        upper = (torch.arange(n - r0, device=x.device)[None, :] > torch.arange(r1 - r0, device=x.device)[:, None])
        prod = sx * sy
        counts += torch.stack([((prod > 0) & upper).sum(), ((prod < 0) & upper).sum(),
                               ((sx == 0) & (sy != 0) & upper).sum(), ((sy == 0) & (sx != 0) & upper).sum()])
    return counts


def _distinct(x: Tensor) -> Tensor:
    """The number of distinct values (each NaN distinct), for tau-c (``kendall.py:52-53``)."""
    s = torch.sort(x).values
    return 1 + (s[1:] != s[:-1]).sum()


def _tie_moments(x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(Σt(t-1)/2, Σt(t-1)(t-2), Σt(t-1)(2t+5)) over the tie groups of ``x`` (``kendall.py:58``)."""
    t = _tie_groups(x)[2].to(torch.float32)
    return torch.sum(t * (t - 1)) / 2, torch.sum(t * (t - 1) * (t - 2)), torch.sum(t * (t - 1) * (2 * t + 5))


def _kendall_tau(con: Tensor, dis: Tensor, tx: Tensor, ty: Tensor, n: Tensor, variant: str, x: Tensor,
                 y: Tensor) -> Tensor:
    """``kendall.py:42``."""
    if variant == "a":
        return (con - dis) / (n * (n - 1) / 2)
    if variant == "b":
        denom = torch.sqrt((con + dis + tx) * (con + dis + ty))
        return (con - dis) / torch.where(denom == 0, 1.0, denom)
    m = torch.minimum(_distinct(x), _distinct(y)).to(torch.float32)
    return 2 * (con - dis) / (n * n * (m - 1) / torch.where(m == 0, 1.0, m))


def _ndtr(t: Tensor) -> Tensor:
    """The standard normal CDF as ``jax.scipy.stats.norm.cdf`` computes it in its lower tail,
    ``erfc(-t / sqrt 2) / 2``. ``torch.special.ndtr`` loses the tails in float32 (2.98e-7 at
    t = -5 on the CPU, against 2.87e-7; 0 below -8), where p-values of strong correlations lie."""
    return 0.5 * torch.special.erfc(-t * math.sqrt(0.5))


def _kendall_pvalue(con: Tensor, dis: Tensor, n: Tensor, variant: str, alternative: str, x: Tensor,
                    y: Tensor) -> Tensor:
    """The normal approximation's p-value, tie-corrected for tau-b and tau-c (``kendall.py:74``)."""
    con_min_dis = con - dis
    base = n * (n - 1) * (2 * n + 5)
    if variant == "a":
        t_value = 3 * con_min_dis / torch.sqrt(base / 2)
    else:
        xtie, x1, x2 = _tie_moments(x)
        ytie, y1, y2 = _tie_moments(y)
        m = n * (n - 1)
        denom = (base - x2 - y2) / 18
        denom = denom + (2 * xtie * ytie) / m
        denom = denom + x1 * y1 / (9 * m * (n - 2))
        t_value = con_min_dis / torch.sqrt(denom)
    if alternative == "two-sided":
        return 2 * _ndtr(-torch.abs(t_value))
    if alternative == "greater":
        return _ndtr(-t_value)
    return _ndtr(t_value)


def _kendall_corrcoef_compute(preds: Tensor, target: Tensor, variant: str = "b", t_test: bool = False,
                              alternative: Optional[str] = "two-sided") -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """tau (and the p-value) of ``(N,)`` inputs, or of each column of ``(N, d)`` inputs."""
    columns = [(preds, target)] if preds.ndim == 1 else [(preds[:, i], target[:, i]) for i in range(preds.shape[1])]
    taus: List[Tensor] = []
    pvalues: List[Tensor] = []
    for x, y in columns:
        con, dis, tx, ty = _pair_counts(x, y).to(torch.float32).unbind()
        n = _num_obs(x.shape[0], x)
        taus.append(_kendall_tau(con, dis, tx, ty, n, variant, x, y))
        if t_test:
            pvalues.append(_kendall_pvalue(con, dis, n, variant, alternative, x, y))
    tau = taus[0] if preds.ndim == 1 else torch.stack(taus)
    if not t_test:
        return tau
    return tau, pvalues[0] if preds.ndim == 1 else torch.stack(pvalues)


def kendall_rank_corrcoef(preds: Tensor, target: Tensor, variant: str = "b", t_test: bool = False,
                          alternative: Optional[str] = "two-sided") -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Kendall rank correlation (``kendall.py:101``).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional import kendall_rank_corrcoef
        >>> preds, target = torch.tensor([2.5, 1.0, 2.0, 8.0]), torch.tensor([3.0, 0.5, 2.0, 7.0])
        >>> print(f"{float(kendall_rank_corrcoef(preds, target)):.4f}")
        1.0000
    """
    _check_kendall_args(variant, t_test, alternative)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    _check_data_shape_to_num_outputs(preds, target, 1 if preds.ndim == 1 else preds.shape[1])
    return _kendall_corrcoef_compute(preds, target, variant, t_test, alternative)
