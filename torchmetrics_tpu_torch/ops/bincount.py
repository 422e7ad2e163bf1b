"""K1, the exact bincount: the wrapper of ``csrc/bincount.cu`` and its plain PyTorch version.

Replaces ``torchmetrics_tpu/ops/pallas_hist.py::_bincount_kernel`` (``:28``, entry
``bincount_pallas`` ``:63``). Two entries share the kernel body:

- :func:`bincount` counts each value of an int32 or int64 index stream in ``[0, length)``;
- :func:`confusion_counts` counts ``target * C + pred`` into ``C * C`` bins, formed in
  registers from int32 or int64 ``preds`` and ``target``; a sample is dropped when either
  label falls outside ``[0, C)``, when ``target == ignore_index``, or when ``mask`` is 0.

Counts are exact integers in the caller's ``dtype`` (int32 or int64), written by the kernel
itself: one launch per call, with no fill before it and no cast after it. They do not depend on
the order of the adds.

What bounds the kernel on an H100: the HBM bytes it must read, 4 or 8 B per index or 8 to 16 B
per confusion sample (1 B more with a mask), against 3.35 TB/s; the output is small.
``csrc/bincount.cu`` says how its two branches write the whole output in one launch.

On a CPU tensor each entry runs its plain version. On a CUDA tensor it launches the kernel or
raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops import _build

#: the largest ``num_classes`` whose ``C * C`` fused index fits an int32
MAX_CONFUSION_CLASSES = 46340
_INDEX_DTYPES = (torch.int32, torch.int64)
#: the dtypes the kernel writes its counts in
COUNT_DTYPES = (torch.int32, torch.int64)
_MAX_N = 2**31 - 1


class LaunchCounter:
    """Launches of one kernel: the wrapper adds one where it launches the kernel, and nowhere else."""

    def __init__(self) -> None:
        self.launches = 0


BINCOUNT = LaunchCounter()

_SHARED_BINS: Dict[int, int] = {}
_ZEROED: Dict[Tuple[int, int], Tensor] = {}
_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with every entry's C signature declared."""
    global _LIB
    if _LIB is None:
        lib = _build.library("bincount")
        c_int, c_ll, c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.tm_bincount.argtypes = [c_ptr, c_int, c_ll, c_int, c_ptr, c_int, c_ptr, c_int, c_ptr]
        lib.tm_bincount.restype = c_int
        lib.tm_confusion.argtypes = [
            c_ptr, c_int, c_ptr, c_int, c_ptr, c_ll, c_int, c_ll, c_int, c_ptr, c_int, c_ptr, c_int, c_ptr,
        ]
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
    if x.get_device() != device.index:  # an int compare: no torch.device is built on the hot path
        raise ValueError(f"`{name}` lies on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"`{name}` must be contiguous")


def _stream(device: torch.device) -> int:
    """The current stream of ``device`` as a raw pointer, without building a ``torch.cuda.Stream``."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in COUNT_DTYPES:
        raise TypeError(f"counts are written as int32 or int64, got {dtype}")


def zeroed_scratch(device: torch.device, stream: int, words: int) -> Tensor:
    """int32 scratch of at least ``words`` zeros for the kernels' cross-block sums on ``stream``.

    Each kernel that uses it (K1's shared branch, K3's binned entry) adds into it and leaves it
    zeroed again at its end: the last block to finish reads the sums, then clears them and the
    ticket that told it it was last. So one buffer per device and stream is allocated, zero-filled
    once, and kept; calls on one stream run in order and never share it while it is dirty. Under
    CUDA-graph capture the buffer is allocated afresh and not kept, so its zero fill is captured
    and every replay starts clean.
    """
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(words, dtype=torch.int32, device=device)
    key = (device.index, stream)
    buf = _ZEROED.get(key)
    if buf is None or buf.numel() < words:
        buf = _ZEROED[key] = torch.zeros(max(words, 1024), dtype=torch.int32, device=device)
    return buf


# ------------------------------------------------------------------ plain versions
def bincount_plain(x: Tensor, length: int, dtype: torch.dtype = torch.int32) -> Tensor:
    """Plain version of :func:`bincount`: remap invalid values to a sentinel bin, count, slice."""
    x = x.reshape(-1)
    idx = torch.where((x >= 0) & (x < length), x, length).to(torch.int64)
    return torch.bincount(idx, minlength=length + 1)[:length].to(dtype)


def confusion_counts_plain(
    preds: Tensor, target: Tensor, num_classes: int, mask: Optional[Tensor] = None,
    ignore_index: Optional[int] = None, dtype: torch.dtype = torch.int32,
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
    return torch.bincount(fused, minlength=bins + 1)[:bins].to(dtype).reshape(num_classes, num_classes)


# ------------------------------------------------------------------ entries
def _launch(lib: ctypes.CDLL, fn, args: tuple, out: Tensor, length: int, device: torch.device, what: str) -> None:
    """Launch ``fn(*args, out, dtype flag, scratch, device, stream)`` on the current stream."""
    stream = _stream(device)
    bins_max = _SHARED_BINS.get(device.index) or shared_bins_max(device)
    scratch = zeroed_scratch(device, stream, length + 32) if length <= bins_max else None
    rc = fn(*args, out.data_ptr(), int(out.dtype == torch.int64), None if scratch is None else scratch.data_ptr(),
            device.index, stream)
    _check_rc(lib, rc, what)
    BINCOUNT.launches += 1


def bincount(x: Tensor, length: int, dtype: torch.dtype = torch.int32) -> Tensor:
    """Counts of each value of ``x`` in ``[0, length)`` as ``dtype``, shape ``(length,)``; other values are dropped."""
    _check_index(x, "x")
    _check_dtype(dtype)
    if length < 1:
        raise ValueError(f"`length` must be positive, got {length}")
    if x.device.type == "cpu":
        return bincount_plain(x, length, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"bincount runs on CPU or CUDA tensors, got {x.device}")
    _check_cuda(x, "x", x.device)
    if x.numel() == 0:
        return torch.zeros(length, dtype=dtype, device=x.device)
    out = torch.empty(length, dtype=dtype, device=x.device)  # the kernel writes every bin
    lib = _library()
    _launch(lib, lib.tm_bincount, (x.data_ptr(), int(x.dtype == torch.int64), x.numel(), length), out, length,
            x.device, "bincount kernel launch")
    return out


def confusion_counts(
    preds: Tensor, target: Tensor, num_classes: int, mask: Optional[Tensor] = None,
    ignore_index: Optional[int] = None, dtype: torch.dtype = torch.int32,
) -> Tensor:
    """``(C, C)`` counts as ``dtype``, rows = target, columns = preds, of the samples kept.

    ``mask`` is a bool or uint8 tensor with one entry per sample.
    """
    _check_index(preds, "preds")
    _check_index(target, "target")
    _check_dtype(dtype)
    if preds.numel() != target.numel():
        raise ValueError(f"`preds` and `target` hold {preds.numel()} and {target.numel()} values")
    if mask is not None:
        if mask.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"`mask` must be bool or uint8, got {mask.dtype}")
        if mask.numel() != target.numel():
            raise ValueError(f"`mask` holds {mask.numel()} values, expected {target.numel()}")
    if not 1 <= num_classes <= MAX_CONFUSION_CLASSES:
        raise ValueError(f"`num_classes` must be in [1, {MAX_CONFUSION_CLASSES}], got {num_classes}")
    device = target.device
    if device.type == "cpu" and preds.device.type == "cpu" and (mask is None or mask.device.type == "cpu"):
        return confusion_counts_plain(preds, target, num_classes, mask, ignore_index, dtype)
    if device.type != "cuda":
        tensors = [preds, target] if mask is None else [preds, target, mask]
        raise ValueError(f"confusion_counts takes tensors on the CPU or on one CUDA device, got {[t.device for t in tensors]}")
    _check_cuda(preds, "preds", device)
    _check_cuda(target, "target", device)
    if mask is not None:
        _check_cuda(mask, "mask", device)
    if target.numel() == 0:
        return torch.zeros((num_classes, num_classes), dtype=dtype, device=device)
    out = torch.empty((num_classes, num_classes), dtype=dtype, device=device)  # the kernel writes every bin
    lib = _library()
    args = (
        preds.data_ptr(), int(preds.dtype == torch.int64), target.data_ptr(), int(target.dtype == torch.int64),
        None if mask is None else mask.data_ptr(), 0 if ignore_index is None else int(ignore_index),
        int(ignore_index is not None), target.numel(), num_classes,
    )
    _launch(lib, lib.tm_confusion, args, out, num_classes * num_classes, device, "confusion kernel launch")
    return out
