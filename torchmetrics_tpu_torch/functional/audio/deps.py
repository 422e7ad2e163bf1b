"""PESQ and STOI through their host packages (counterpart of ``torchmetrics_tpu/functional/audio/deps.py``).

Both are ITU-standard signal processing on the host, which the reference runs through ``pesq`` and
``pystoi``. Where those packages import, each sample goes to them in float32 numpy, as in the JAX
package; where they do not, the entries and classes raise the JAX package's (the reference's)
``ModuleNotFoundError`` text. The scores land on the inputs' device.
"""
from __future__ import annotations

import importlib.util

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.utils.checks import _check_same_shape

_PESQ_AVAILABLE = importlib.util.find_spec("pesq") is not None
_PYSTOI_AVAILABLE = importlib.util.find_spec("pystoi") is not None


def _require_pesq() -> None:
    if not _PESQ_AVAILABLE:
        raise ModuleNotFoundError(
            "PESQ metric requires that pesq is installed. Either install as `pip install"
            " torchmetrics[audio]` or `pip install pesq`."
        )


def _require_pystoi() -> None:
    if not _PYSTOI_AVAILABLE:
        raise ModuleNotFoundError(
            "STOI metric requires that pystoi is installed. Either install as `pip install"
            " torchmetrics[audio]` or `pip install pystoi`."
        )


def _rows(x: Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float32).numpy().reshape(-1, x.shape[-1])


def perceptual_evaluation_speech_quality(
    preds: Tensor,
    target: Tensor,
    fs: int,
    mode: str,
    keep_same_device: bool = False,
    n_processes: int = 1,
) -> Tensor:
    """PESQ through the ``pesq`` package (JAX ``deps.py:40``), one sample at a time; a silent sample
    gives NaN. ``n_processes`` is accepted for the reference's signature; evaluation is serial."""
    _require_pesq()
    import pesq as pesq_backend

    if fs not in (8000, 16000):
        raise ValueError(f"Argument `fs` must be either 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")
    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    _check_same_shape(preds, target)
    preds_np, target_np = _rows(preds), _rows(target)
    pesq_val = np.empty(preds_np.shape[0], np.float32)
    for b in range(preds_np.shape[0]):
        try:
            pesq_val[b] = pesq_backend.pesq(fs, target_np[b], preds_np[b], mode)
        except pesq_backend.NoUtterancesError:
            pesq_val[b] = np.nan
    return torch.from_numpy(pesq_val.reshape(preds.shape[:-1])).to(preds.device)


def short_time_objective_intelligibility(
    preds: Tensor, target: Tensor, fs: int, extended: bool = False, keep_same_device: bool = False
) -> Tensor:
    """STOI through the ``pystoi`` package (JAX ``deps.py:72``), one sample at a time."""
    _require_pystoi()
    from pystoi import stoi as stoi_backend

    preds, target = torch.as_tensor(preds), torch.as_tensor(target)
    _check_same_shape(preds, target)
    preds_np, target_np = _rows(preds), _rows(target)
    stoi_val = np.empty(preds_np.shape[0], np.float32)
    for b in range(preds_np.shape[0]):
        stoi_val[b] = stoi_backend(target_np[b], preds_np[b], fs, extended=extended)
    return torch.from_numpy(stoi_val.reshape(preds.shape[:-1])).to(preds.device)
