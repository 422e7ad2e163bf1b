"""K2, the weighted histogram pair: the wrapper of ``csrc/hist_pair.cu`` and its plain version.

Replaces ``torchmetrics_tpu/ops/pallas_hist.py::_hist_pair_kernel`` (``:92``, entry
``hist_pair_pallas`` ``:139``). :func:`hist_pair` returns the ``(2, length)`` float32 weighted
histograms of an int32 or int64 index stream under two float32 weight streams, in one pass;
indices outside ``[0, length)`` are dropped. ``neg_w=None`` stands for a zero second stream,
which the kernel then does not read (the weighted bincount and the weighted confusion count of
``ops/histogram.py`` use one stream).

Contract on order: the kernel adds with float atomics. With 0/1 weights, as every caller of the
curve sketch passes, each bin's sums are integers below 2^24, exact and repeatable; general
weights give sums whose last bits may differ from run to run.

What bounds the kernel on an H100: the HBM bytes it reads, 12 or 16 B per sample. On a CPU tensor
the entry runs its plain version; on a CUDA tensor it launches the kernel or raises, and nothing
falls back.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops import _build
from torchmetrics_tpu_torch.ops.bincount import _INDEX_DTYPES, LaunchCounter, _check_cuda, _stream

HIST_PAIR = LaunchCounter()

#: the longest histogram the kernel takes: 2 * length bins must index an int
MAX_LENGTH = 2**30

_SHARED_BINS: Dict[int, int] = {}
_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with every entry's C signature declared."""
    global _LIB
    if _LIB is None:
        lib = _build.library("hist_pair")
        c_int, c_ll, c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.tm_hist_pair.argtypes = [c_ptr, c_int, c_ptr, c_ptr, c_ll, c_int, c_ptr, c_int, c_ptr]
        lib.tm_hist_pair.restype = c_int
        lib.tm_hist_pair_shared_bins_max.argtypes = [c_int, ctypes.POINTER(c_int)]
        lib.tm_hist_pair_shared_bins_max.restype = c_int
        lib.tm_hist_pair_error_string.argtypes = [c_int]
        lib.tm_hist_pair_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed on the card: {lib.tm_hist_pair_error_string(rc).decode()} (cudaError {rc})")


def shared_bins_max(device: torch.device) -> int:
    """Bins the shared-memory branch holds on ``device``; longer histograms add in global memory."""
    index = torch.device(device).index or 0
    bins = _SHARED_BINS.get(index)
    if bins is None:
        lib = _library()
        out = ctypes.c_int(0)
        _check_rc(lib, lib.tm_hist_pair_shared_bins_max(index, ctypes.byref(out)), "tm_hist_pair_shared_bins_max")
        bins = _SHARED_BINS[index] = out.value
    return bins


def branch(length: int, device: torch.device) -> str:
    """Which branch of the kernel a pair of ``length`` bins takes: ``shared`` or ``global``."""
    return "shared" if length <= shared_bins_max(device) else "global"


# ------------------------------------------------------------------ plain version
def hist_pair_plain(idx: Tensor, pos_w: Tensor, neg_w: Optional[Tensor], length: int) -> Tensor:
    """Plain version of :func:`hist_pair`: remap dropped indices to a sentinel bin, then one
    ``index_add_`` of both weight streams."""
    idx = idx.reshape(-1)
    bins = torch.where((idx >= 0) & (idx < length), idx, length).to(torch.int64)
    neg = torch.zeros_like(pos_w) if neg_w is None else neg_w
    out = torch.zeros((length + 1, 2), dtype=torch.float32, device=idx.device)
    out.index_add_(0, bins, torch.stack([pos_w.reshape(-1), neg.reshape(-1)], dim=1))
    return out[:length].T.contiguous()


# ------------------------------------------------------------------ entry
def hist_pair(idx: Tensor, pos_w: Tensor, neg_w: Optional[Tensor], length: int) -> Tensor:
    """``(2, length)`` float32 weighted histograms of ``idx`` under ``pos_w`` (row 0) and ``neg_w`` (row 1)."""
    if idx.dtype not in _INDEX_DTYPES:
        raise TypeError(f"`idx` must be int32 or int64, got {idx.dtype}")
    weights = [pos_w] if neg_w is None else [pos_w, neg_w]
    for w in weights:
        if w.dtype != torch.float32:
            raise TypeError(f"weights must be float32, got {w.dtype}")
        if w.numel() != idx.numel():
            raise ValueError(f"weights hold {w.numel()} values, expected one per index ({idx.numel()})")
    if not 1 <= length <= MAX_LENGTH:
        raise ValueError(f"`length` must be in [1, {MAX_LENGTH}], got {length}")
    tensors = [idx, *weights]
    if all(t.device.type == "cpu" for t in tensors):
        return hist_pair_plain(idx, pos_w, neg_w, length)
    device = idx.device
    if device.type != "cuda":
        raise ValueError(f"hist_pair takes tensors on the CPU or on one CUDA device, got {[t.device for t in tensors]}")
    for name, x in zip(("idx", "pos_w", "neg_w"), tensors):
        _check_cuda(x, name, device)
    out = torch.zeros((2, length), dtype=torch.float32, device=device)
    if idx.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.tm_hist_pair(
            idx.data_ptr(), int(idx.dtype == torch.int64), pos_w.data_ptr(), None if neg_w is None else neg_w.data_ptr(),
            idx.numel(), length, out.data_ptr(), device.index, _stream(device),
        )
    _check_rc(lib, rc, "hist_pair kernel launch")
    HIST_PAIR.launches += 1
    return out
