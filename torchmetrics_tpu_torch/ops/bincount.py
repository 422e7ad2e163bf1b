"""K1, the int32 bincount: the wrapper of ``csrc/bincount.cu`` and its plain PyTorch version.

Replaces ``torchmetrics_tpu/ops/pallas_hist.py::_bincount_kernel`` (``:28``, entry
``bincount_pallas`` ``:63``). Two entries share the kernel body:

- :func:`bincount` counts each value of an int32 or int64 index stream in ``[0, length)``;
- :func:`confusion_counts` counts ``target * C + pred`` into ``C * C`` bins, formed in
  registers from int32 or int64 ``preds`` and ``target``; a sample is dropped when either
  label falls outside ``[0, C)``, when ``target == ignore_index``, or when ``mask`` is 0.

Counts are int32, exact past 2^24, and do not depend on the order of the adds.

What bounds the kernel on an H100: the HBM bytes it must read, 4 or 8 B per index or 8 to 16 B
per confusion sample (1 B more with a mask), against 3.35 TB/s; the output is small. What is
likely to hold it below that bound: at C = 5 there are only 25 bins, so every warp contends on
the same shared-memory words. Per-warp sub-histograms are the fix, left for a later change.

On a CPU tensor each entry runs its plain version. On a CUDA tensor it launches the kernel or
raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops import _build

#: the largest ``num_classes`` whose ``C * C`` fused index fits an int32
MAX_CONFUSION_CLASSES = 46340
_INDEX_DTYPES = (torch.int32, torch.int64)
_MAX_N = 2**31 - 1


class LaunchCounter:
    """Launches of one kernel: the wrapper adds one where it launches the kernel, and nowhere else."""

    def __init__(self) -> None:
        self.launches = 0


BINCOUNT = LaunchCounter()

_SHARED_BINS: Dict[int, int] = {}
_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with every entry's C signature declared."""
    global _LIB
    if _LIB is None:
        lib = _build.library("bincount")
        c_int, c_ll, c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.tm_bincount.argtypes = [c_ptr, c_int, c_ll, c_int, c_ptr, c_int, c_ptr]
        lib.tm_bincount.restype = c_int
        lib.tm_confusion.argtypes = [c_ptr, c_int, c_ptr, c_int, c_ptr, c_ll, c_int, c_ll, c_int, c_ptr, c_int, c_ptr]
        lib.tm_confusion.restype = c_int
        lib.tm_shared_bins_max.argtypes = [c_int, ctypes.POINTER(c_int)]
        lib.tm_shared_bins_max.restype = c_int
        lib.tm_error_string.argtypes = [c_int]
        lib.tm_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed on the card: {lib.tm_error_string(rc).decode()} (cudaError {rc})")


def shared_bins_max(device: torch.device) -> int:
    """Bins the shared-memory branch holds on ``device``; longer histograms count in global memory."""
    index = torch.device(device).index or 0
    bins = _SHARED_BINS.get(index)
    if bins is None:
        lib = _library()
        out = ctypes.c_int(0)
        _check_rc(lib, lib.tm_shared_bins_max(index, ctypes.byref(out)), "tm_shared_bins_max")
        bins = _SHARED_BINS[index] = out.value
    return bins


def branch(length: int, device: torch.device) -> str:
    """Which branch of the kernel a histogram of ``length`` bins takes: ``shared`` or ``global``."""
    return "shared" if length <= shared_bins_max(device) else "global"


def _check_index(x: Tensor, name: str) -> None:
    if x.dtype not in _INDEX_DTYPES:
        raise TypeError(f"`{name}` must be int32 or int64, got {x.dtype}")
    if x.numel() > _MAX_N:
        raise ValueError(f"`{name}` holds {x.numel()} values; the kernel counts at most 2^31 - 1")


def _check_cuda(x: Tensor, name: str, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"`{name}` lies on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"`{name}` must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------------------------ plain versions
def bincount_plain(x: Tensor, length: int) -> Tensor:
    """Plain version of :func:`bincount`: remap invalid values to a sentinel bin, count, slice."""
    x = x.reshape(-1)
    idx = torch.where((x >= 0) & (x < length), x, length).to(torch.int64)
    return torch.bincount(idx, minlength=length + 1)[:length].to(torch.int32)


def confusion_counts_plain(
    preds: Tensor, target: Tensor, num_classes: int, mask: Optional[Tensor] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Plain version of :func:`confusion_counts`."""
    p = preds.reshape(-1).to(torch.int64)
    t = target.reshape(-1).to(torch.int64)
    keep = (t >= 0) & (t < num_classes) & (p >= 0) & (p < num_classes)
    if ignore_index is not None:
        keep &= t != ignore_index
    if mask is not None:
        keep &= mask.reshape(-1) != 0
    bins = num_classes * num_classes
    fused = torch.where(keep, t * num_classes + p, bins)
    return torch.bincount(fused, minlength=bins + 1)[:bins].to(torch.int32).reshape(num_classes, num_classes)


# ------------------------------------------------------------------ entries
def bincount(x: Tensor, length: int) -> Tensor:
    """int32 counts of each value of ``x`` in ``[0, length)``, shape ``(length,)``; other values are dropped."""
    _check_index(x, "x")
    if length < 1:
        raise ValueError(f"`length` must be positive, got {length}")
    if x.device.type == "cpu":
        return bincount_plain(x, length)
    if x.device.type != "cuda":
        raise ValueError(f"bincount runs on CPU or CUDA tensors, got {x.device}")
    _check_cuda(x, "x", x.device)
    out = torch.zeros(length, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        rc = lib.tm_bincount(
            x.data_ptr(), int(x.dtype == torch.int64), x.numel(), length, out.data_ptr(),
            x.device.index, _stream(x.device),
        )
    _check_rc(lib, rc, "bincount kernel launch")
    BINCOUNT.launches += 1
    return out


def confusion_counts(
    preds: Tensor, target: Tensor, num_classes: int, mask: Optional[Tensor] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """``(C, C)`` int32 counts, rows = target, columns = preds, of the samples kept.

    ``mask`` is a bool or uint8 tensor with one entry per sample.
    """
    _check_index(preds, "preds")
    _check_index(target, "target")
    if preds.numel() != target.numel():
        raise ValueError(f"`preds` and `target` hold {preds.numel()} and {target.numel()} values")
    if mask is not None:
        if mask.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"`mask` must be bool or uint8, got {mask.dtype}")
        if mask.numel() != target.numel():
            raise ValueError(f"`mask` holds {mask.numel()} values, expected {target.numel()}")
    if not 1 <= num_classes <= MAX_CONFUSION_CLASSES:
        raise ValueError(f"`num_classes` must be in [1, {MAX_CONFUSION_CLASSES}], got {num_classes}")
    tensors = [preds, target] if mask is None else [preds, target, mask]
    if all(t.device.type == "cpu" for t in tensors):
        return confusion_counts_plain(preds, target, num_classes, mask, ignore_index)
    device = target.device
    if device.type != "cuda":
        raise ValueError(f"confusion_counts takes tensors on the CPU or on one CUDA device, got {[t.device for t in tensors]}")
    _check_cuda(preds, "preds", device)
    _check_cuda(target, "target", device)
    if mask is not None:
        _check_cuda(mask, "mask", device)
    out = torch.zeros((num_classes, num_classes), dtype=torch.int32, device=device)
    if target.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.tm_confusion(
            preds.data_ptr(), int(preds.dtype == torch.int64), target.data_ptr(), int(target.dtype == torch.int64),
            None if mask is None else mask.data_ptr(), 0 if ignore_index is None else int(ignore_index),
            int(ignore_index is not None), target.numel(), num_classes, out.data_ptr(), device.index,
            _stream(device),
        )
    _check_rc(lib, rc, "confusion kernel launch")
    BINCOUNT.launches += 1
    return out
