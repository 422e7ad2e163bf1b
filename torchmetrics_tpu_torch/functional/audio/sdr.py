"""SDR (counterpart of ``torchmetrics_tpu/functional/audio/sdr.py``).

The optimal distortion filter solves the Toeplitz normal equations built from FFT auto- and
cross-correlations: ``rfft``/``irfft`` at ``n_fft = 2^ceil(log2(2T - 1))``, the symmetric Toeplitz
matrix gathered from its first row by ``|i - j|`` indices made on the device, and one batched solve,
in float32 as the JAX package keeps it (the reference promotes to float64).

The system is an autocorrelation matrix, symmetric positive definite, and the port solves it by
Cholesky (``cholesky_ex`` and ``cholesky_solve``, no check) where JAX's ``jnp.linalg.solve`` takes LU:
the same solution to float32 rounding (queue C of the roadmap). On the card the solve runs on cuSOLVER
(``_cusolver``): MAGMA, which PyTorch picks for a batched solve, allocates and synchronises inside the
call, so a CUDA graph cannot capture it, and cuSOLVER's LU takes one factorisation a system where its
Cholesky is batched (``profile_port.py Q`` times the update). No check reads ``info`` back to the host;
a singular system gives NaN, as JAX's unchecked solve gives a non-finite value. cuFFT builds its plan at the first call, which the graph tier's warm-up
makes before it captures.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Iterator, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.utils.checks import _check_same_shape
from torchmetrics_tpu_torch.utils.precision import full_float32
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

_warned_cg_iter = False


@contextmanager
def _cusolver(device: torch.device) -> Iterator[None]:
    """cuSOLVER for the linear algebra inside the scope on a CUDA device, the caller's choice put back."""
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(saved)


def _spd_solve(r: Tensor, b: Tensor) -> Tensor:
    """``r x = b`` for a batch of symmetric positive definite ``r`` by Cholesky, with no check."""
    with full_float32(), _cusolver(r.device):
        factor = torch.linalg.cholesky_ex(r, check_errors=False).L
        return torch.cholesky_solve(b[..., None], factor)[..., 0]


def _symmetric_toeplitz(r0: Tensor) -> Tensor:
    """``T[i, j] = r0[|i - j|]`` from the first row (JAX ``sdr.py:23``)."""
    n = r0.shape[-1]
    pos = torch.arange(n, device=r0.device)
    return r0[..., torch.abs(pos[:, None] - pos[None, :])]


def _compute_autocorr_crosscorr(target: Tensor, preds: Tensor, corr_len: int):
    """FFT autocorrelation of ``target`` and its cross-correlation with ``preds`` (JAX ``sdr.py:30``)."""
    n_fft = 2 ** math.ceil(math.log2(preds.shape[-1] + target.shape[-1] - 1))
    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    r_0 = torch.fft.irfft(torch.square(t_fft.real) + torch.square(t_fft.imag), n=n_fft)[..., :corr_len]
    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    b = torch.fft.irfft(torch.conj(t_fft) * p_fft, n=n_fft, dim=-1)[..., :corr_len]
    return r_0, b


def signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> Tensor:
    """SDR in dB per sample (JAX ``sdr.py:40``).

    ``use_cg_iter`` is accepted for the reference's signature, with one warning a process; the direct
    batched solve is always used.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import signal_distortion_ratio
        >>> g = torch.Generator().manual_seed(1)
        >>> target = torch.randn(8000, generator=g)
        >>> preds = 0.9 * target + 0.05 * torch.randn(8000, generator=g)
        >>> print(f"{float(signal_distortion_ratio(preds, target)):.1f}")
        25.4
    """
    global _warned_cg_iter
    if use_cg_iter is not None and not _warned_cg_iter:
        _warned_cg_iter = True
        rank_zero_warn(
            "`use_cg_iter` is accepted for API parity but ignored: the direct batched "
            "Toeplitz solve is always used, so numerics may differ slightly from the reference's "
            "conjugate-gradient approximation."
        )
    preds = torch.as_tensor(preds, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    _check_same_shape(preds, target)

    if zero_mean:
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
        target = target - torch.mean(target, dim=-1, keepdim=True)

    target = target / torch.clamp(torch.linalg.vector_norm(target, dim=-1, keepdim=True), min=1e-6)
    preds = preds / torch.clamp(torch.linalg.vector_norm(preds, dim=-1, keepdim=True), min=1e-6)

    r_0, b = _compute_autocorr_crosscorr(target, preds, corr_len=filter_length)
    if load_diag is not None:
        r_0 = torch.cat([r_0[..., :1] + load_diag, r_0[..., 1:]], dim=-1)

    sol = _spd_solve(_symmetric_toeplitz(r_0), b)

    coh = torch.sum(b * sol, dim=-1)
    ratio = coh / (1 - coh)
    return 10.0 * torch.log10(ratio)
