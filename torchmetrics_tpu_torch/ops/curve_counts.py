"""K3, the per-threshold curve counts: the wrapper of ``csrc/curve_counts.cu`` and its plain version.

Replaces ``torchmetrics_tpu/ops/pallas_curve.py::_curve_counts_kernel`` (``:44``, entry
``curve_counts_pallas`` ``:83``) and the class-batched dot of
``functional/classification/precision_recall_curve.py::_indicator_counts`` (``:137``). For
``(C, N)`` scores and weights and ``(T,)`` thresholds, :func:`curve_counts` returns

    ``tp[c, t] = Σ_i pos[c, i]·[scores[c, i] >= thr[t]]`` and the same ``fp`` from ``neg``,

each ``(C, T)`` float32, in one kernel launch for every class. The compare is direct: thresholds
need not be sorted, and a NaN score counts nowhere. Nothing ``(C, N, T)``-shaped is formed: at
C = 5, N = 200,000 and T = 200 that indicator would take 800 MB.

Counts are float32, exact for 0/1 weights while a sum stays below 2^24, as in the JAX package.
The kernel adds in a fixed order, so equal inputs give bitwise equal counts for any weights.

What bounds the kernel on an H100: operations, 3·C·N·T compares and adds (csrc/curve_counts.cu
says what holds it below that). On a CPU tensor the entry runs its plain version; on a CUDA
tensor it launches the kernel or raises, and nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops import _build
from torchmetrics_tpu_torch.ops.bincount import LaunchCounter, _check_cuda, _stream

CURVE_COUNTS = LaunchCounter()

#: samples staged in shared memory per step, as ``kTile`` in the source
TILE = 512
#: thresholds one block covers: 256 threads of at most 8 each
MAX_THRESHOLDS_PER_BLOCK = 2048
#: elements of the ``(C, chunk, T)`` indicator the plain version forms at once
PLAIN_CHUNK_ELEMENTS = 1 << 24

_LIB: Optional[ctypes.CDLL] = None
_SMS: Dict[int, int] = {}


class LaunchPlan(NamedTuple):
    """How :func:`curve_counts` cuts its work into blocks (see ``csrc/curve_counts.cu``)."""

    per_thread: int  # thresholds one thread holds in registers: 1, 2, 4 or 8
    threads: int  # threads of a block, a multiple of 32 up to 256
    chunks_t: int  # threshold chunks of ``threads * per_thread`` per class
    blocks: int  # sample chunks, each reduced by the second kernel
    chunk: int  # samples of a sample chunk


def launch_plan(n: int, num_classes: int, num_thr: int, sms: int) -> LaunchPlan:
    """The launch shape for ``n`` samples of ``num_classes`` rows against ``num_thr`` thresholds.

    A thread takes up to 8 thresholds, so that one shared-memory read feeds several compares,
    and a block up to 256 threads. Sample chunks are added until about four blocks per
    multiprocessor are in flight, and never below one tile of samples per block.
    """
    per_thread = 1
    while per_thread < 8 and per_thread * 128 < num_thr:
        per_thread *= 2
    lanes = -(-min(num_thr, MAX_THRESHOLDS_PER_BLOCK) // per_thread)
    threads = min(256, 32 * -(-lanes // 32))
    chunks_t = -(-num_thr // (threads * per_thread))
    rows = num_classes * chunks_t
    blocks = max(1, min(-(-n // TILE), -(-4 * sms // rows)))
    chunk = max(1, -(-n // blocks))
    blocks = max(1, -(-n // chunk))
    return LaunchPlan(per_thread, threads, chunks_t, blocks, chunk)


def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with every entry's C signature declared."""
    global _LIB
    if _LIB is None:
        lib = _build.library("curve_counts")
        c_int, c_ll, c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.tm_curve_counts.argtypes = [
            c_ptr, c_ptr, c_ptr, c_ptr, c_ll, c_int, c_int, c_int, c_int, c_int, c_int, c_ll, c_ptr, c_ptr, c_int, c_ptr,
        ]
        lib.tm_curve_counts.restype = c_int
        lib.tm_curve_counts_error_string.argtypes = [c_int]
        lib.tm_curve_counts_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _multiprocessors(device: torch.device) -> int:
    index = device.index or 0
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


# ------------------------------------------------------------------ plain version
def curve_counts_plain(scores: Tensor, pos: Tensor, neg: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`curve_counts`: compare and sum in chunks of samples, so that
    memory stays ``O(C·chunk·T)``."""
    num_classes, n = scores.shape
    thr = thresholds.reshape(1, 1, -1)
    tp = torch.zeros((num_classes, thr.shape[-1]), dtype=torch.float32, device=scores.device)
    fp = torch.zeros_like(tp)
    step = max(1, PLAIN_CHUNK_ELEMENTS // max(1, num_classes * thr.shape[-1]))
    for i in range(0, n, step):
        hit = (scores[:, i:i + step, None] >= thr).to(torch.float32)  # (C, chunk, T)
        tp += (pos[:, i:i + step, None] * hit).sum(dim=1)
        fp += (neg[:, i:i + step, None] * hit).sum(dim=1)
    return tp, fp


# ------------------------------------------------------------------ entry
def _check(scores: Tensor, pos: Tensor, neg: Tensor, thresholds: Tensor) -> None:
    for name, x in (("scores", scores), ("pos", pos), ("neg", neg), ("thresholds", thresholds)):
        if x.dtype != torch.float32:
            raise TypeError(f"`{name}` must be float32, got {x.dtype}")
    if scores.ndim != 2:
        raise ValueError(f"`scores` must be (C, N), got shape {tuple(scores.shape)}")
    if pos.shape != scores.shape or neg.shape != scores.shape:
        raise ValueError(f"`pos` {tuple(pos.shape)} and `neg` {tuple(neg.shape)} must match `scores` {tuple(scores.shape)}")
    if thresholds.ndim != 1 or thresholds.numel() < 1:
        raise ValueError(f"`thresholds` must be a non-empty 1-D tensor, got shape {tuple(thresholds.shape)}")


def curve_counts(scores: Tensor, pos: Tensor, neg: Tensor, thresholds: Tensor) -> Tuple[Tensor, Tensor]:
    """``(tp, fp)``, each ``(C, T)`` float32, of ``(C, N)`` float32 scores and weights."""
    _check(scores, pos, neg, thresholds)
    tensors = (scores, pos, neg, thresholds)
    if all(t.device.type == "cpu" for t in tensors):
        return curve_counts_plain(scores, pos, neg, thresholds)
    device = scores.device
    if device.type != "cuda":
        raise ValueError(f"curve_counts takes tensors on the CPU or on one CUDA device, got {[t.device for t in tensors]}")
    for name, x in zip(("scores", "pos", "neg", "thresholds"), tensors):
        _check_cuda(x, name, device)
    num_classes, n = scores.shape
    num_thr = thresholds.numel()
    if n == 0 or num_classes == 0:
        out = torch.zeros((2, num_classes, num_thr), dtype=torch.float32, device=device)
        return out[0], out[1]
    out = torch.empty((2, num_classes, num_thr), dtype=torch.float32, device=device)  # the kernel writes all of it
    plan = launch_plan(n, num_classes, num_thr, _multiprocessors(device))
    scratch = torch.empty(plan.blocks * out.numel() if plan.blocks > 1 else 0, dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        rc = lib.tm_curve_counts(
            scores.data_ptr(), pos.data_ptr(), neg.data_ptr(), thresholds.data_ptr(), n, num_classes, num_thr,
            plan.blocks, plan.threads, plan.per_thread, plan.chunks_t, plan.chunk,
            scratch.data_ptr() if scratch.numel() else None, out.data_ptr(), device.index, _stream(device),
        )
    if rc != 0:
        raise RuntimeError(f"curve_counts kernel launch failed on the card: {lib.tm_curve_counts_error_string(rc).decode()} (cudaError {rc})")
    CURVE_COUNTS.launches += 1
    return out[0], out[1]
