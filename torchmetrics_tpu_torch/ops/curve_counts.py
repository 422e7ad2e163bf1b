"""K3, the per-threshold curve counts: the wrappers of ``csrc/curve_counts.cu`` and their plain versions.

Replaces ``torchmetrics_tpu/ops/pallas_curve.py::_curve_counts_kernel`` (``:44``, entry
``curve_counts_pallas`` ``:83``) and the class-batched dot of
``functional/classification/precision_recall_curve.py::_indicator_counts`` (``:137``). Two entries:

- :func:`binned_confmat`, the binned metric path: the ``(T, 2, 2)`` or ``(T, C, 2, 2)`` float32
  update of the binned state, laid out ``[t, (c,) target, pred]``, of binary, multiclass
  (one-vs-rest) or multilabel scores against **sorted** thresholds, in one launch. It bucketizes
  each score by a binary search and scans the bucket histograms, O(N log T + T) work per class;
  it reads the scores and the raw target in place and drops ``ignore_index`` itself. Counts are
  exact integers, as float32 exact below 2^24 (the JAX package's contract).
- :func:`curve_counts`, general weights and thresholds in any order: for ``(C, N)`` scores and
  weights, ``tp[c, t] = Σ_i pos[c, i]·[scores[c, i] >= thr[t]]`` and the same ``fp`` from
  ``neg``, each ``(C, T)`` float32, by the direct compare, O(N·T). It adds in a fixed order, so
  equal inputs give bitwise equal counts for any weights. The metric path no longer calls it.

A NaN score meets no threshold in both: it counts in no ``tp`` or ``fp``. Nothing
``(C, N, T)``-shaped is formed: at C = 5, N = 200,000 and T = 200 that indicator would take 800 MB.
The caller picks the entry; neither reads the device to choose.

What bounds the kernels on an H100: for :func:`binned_confmat` the bytes it reads (4 B of score
and 1-8 B of target per element) or its ``log2(T) + 4`` operations per element, whichever is
larger; for :func:`curve_counts` its 3·C·N·T compares and adds. On a CPU tensor each entry runs
its plain version; on a CUDA tensor it launches the kernel or raises, and nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops import _build
from torchmetrics_tpu_torch.ops.bincount import LaunchCounter, _check_cuda, _stream, zeroed_scratch

CURVE_COUNTS = LaunchCounter()
BINNED_CONFMAT = LaunchCounter()

#: samples staged in shared memory per step, as ``kTile`` in the source
TILE = 512
#: thresholds one block covers: 256 threads of at most 8 each
MAX_THRESHOLDS_PER_BLOCK = 2048
#: elements of the ``(C, chunk, T)`` indicator the plain version forms at once
PLAIN_CHUNK_ELEMENTS = 1 << 24
#: threads of a block of :func:`binned_confmat`, as ``kBinnedThreads`` in the source
BINNED_THREADS = 512
#: dynamic shared memory a block of :func:`binned_confmat` may take: the default 48 KB, less room
#: for the kernel's own words, so that no opt-in is needed
BINNED_SHARED_BYTES = 47 * 1024
#: the kinds :func:`binned_confmat` takes, by their code in the source
BINNED_KINDS = {"binary": 0, "multiclass": 1, "multilabel": 2}
_TARGET_TYPES = {torch.int32: 0, torch.int64: 1, torch.uint8: 2, torch.bool: 2}

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


class BinnedPlan(NamedTuple):
    """How :func:`binned_confmat` cuts its work into blocks (see ``csrc/curve_counts.cu``)."""

    group: int  # classes whose histograms one block keeps
    groups: int  # class groups, over blockIdx.y
    blocks: int  # sample blocks, over blockIdx.x
    shared_bytes: int  # a block's dynamic shared memory; 0: the histograms live in the global scratch
    head: int  # scratch words of tickets (one per class group) before the cross-block sums


@functools.lru_cache(maxsize=256)
def binned_plan(n: int, num_classes: int, num_thr: int, sms: int) -> BinnedPlan:
    """The launch shape of :func:`binned_confmat` for ``n`` samples of ``num_classes`` classes.

    A block stages the thresholds and as many classes' ``2 * (T + 1)`` histograms as fit in
    ``BINNED_SHARED_BYTES``; when not even one class fits, every class counts in the global
    scratch. Sample blocks are added until about four blocks per multiprocessor are in flight,
    never more than one per ``BINNED_THREADS`` samples.
    """
    words = 2 * (num_thr + 1)
    room = (BINNED_SHARED_BYTES - 4 * num_thr) // (4 * words)
    group = min(num_classes, room) if room >= 1 else num_classes
    shared_bytes = 4 * (num_thr + group * words) if room >= 1 else 0
    groups = -(-num_classes // group)
    blocks = max(1, min(-(-n // BINNED_THREADS), -(-4 * sms // groups)))
    return BinnedPlan(group, groups, blocks, shared_bytes, 32 * -(-groups // 32))


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
        lib.tm_binned_confmat.argtypes = [
            c_ptr, c_ptr, c_int, c_int, c_ll, c_int, c_int, c_ptr, c_int, c_int, c_int, c_int, c_int, c_ll, c_int,
            c_ptr, c_ptr, c_int, c_ptr,
        ]
        lib.tm_binned_confmat.restype = c_int
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


def binned_confmat_plain(
    scores: Tensor, target: Tensor, thresholds: Tensor, kind: str, num_classes: int = 1,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Plain version of :func:`binned_confmat`: ``searchsorted`` buckets, a bincount, a cumulative sum."""
    num_thr = thresholds.numel()
    if kind == "binary":
        scores, target = scores.reshape(-1, 1), target.reshape(-1, 1)
    s = scores.to(torch.float32)
    t = target.to(torch.int64)
    keep = (t != ignore_index) if ignore_index is not None else torch.ones_like(t, dtype=torch.bool)
    if kind == "multiclass":
        positive = t[:, None] == torch.arange(num_classes, device=t.device)[None, :]
        keep = keep[:, None].expand_as(positive)
    else:
        positive = t != 0
    bucket = torch.searchsorted(thresholds, s.contiguous(), right=True)  # #{t : thr[t] <= s}
    bucket = torch.where(torch.isnan(s), 0, bucket)  # a NaN meets no threshold
    classes = torch.arange(s.shape[1], device=s.device)[None, :]
    flat = (classes * 2 + positive.to(torch.int64)) * (num_thr + 1) + bucket
    bins = s.shape[1] * 2 * (num_thr + 1)
    hist = torch.bincount(torch.where(keep, flat, bins).reshape(-1), minlength=bins + 1)[:bins]
    below = torch.cumsum(hist.reshape(s.shape[1], 2, num_thr + 1), dim=-1)  # elements at or below bucket k
    pred0 = below[..., :num_thr]
    pred1 = below[..., -1:] - pred0
    out = torch.stack([pred0, pred1], dim=-1).permute(2, 0, 1, 3).to(torch.float32)  # (T, C, 2, 2)
    return out[:, 0] if kind == "binary" else out


# ------------------------------------------------------------------ entries
def binned_confmat(
    scores: Tensor, target: Tensor, thresholds: Tensor, kind: str, num_classes: int = 1,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """The binned state's update: ``(T, 2, 2)`` (binary) or ``(T, C, 2, 2)`` float32 counts,
    ``[t, (c,) target, pred]``, of the elements kept.

    ``kind`` is ``"binary"`` (``(N,)`` scores and target, positive where the target is not 0),
    ``"multiclass"`` (``(N, C)`` scores and an ``(N,)`` class index, one-vs-rest) or
    ``"multilabel"`` (``(N, C)`` scores and targets, positive where not 0). An element whose
    target equals ``ignore_index`` is dropped (for multiclass, the whole sample). Precondition:
    ``thresholds`` is sorted ascending (``_adjust_threshold_arg`` sorts every grid); it is not
    checked, which would read the device.
    """
    if kind not in BINNED_KINDS:
        raise ValueError(f"`kind` must be one of {sorted(BINNED_KINDS)}, got {kind!r}")
    if scores.dtype != torch.float32 or thresholds.dtype != torch.float32:
        raise TypeError(f"`scores` and `thresholds` must be float32, got {scores.dtype} and {thresholds.dtype}")
    if target.dtype not in _TARGET_TYPES:
        raise TypeError(f"`target` must be int32, int64, uint8 or bool, got {target.dtype}")
    if thresholds.ndim != 1 or thresholds.numel() < 1:
        raise ValueError(f"`thresholds` must be a non-empty 1-D tensor, got shape {tuple(thresholds.shape)}")
    if kind == "binary":
        num_classes = 1
        want = (scores.ndim == 1, target.shape == scores.shape)
    else:
        want = (scores.ndim == 2 and scores.shape[1] == num_classes,
                target.shape == (scores.shape[:1] if kind == "multiclass" else scores.shape))
    if not all(want):
        raise ValueError(f"{kind}: unexpected shapes, scores {tuple(scores.shape)} and target {tuple(target.shape)}"
                         f" for {num_classes} classes")
    device = scores.device
    if device.type == "cpu" and target.device.type == "cpu" and thresholds.device.type == "cpu":
        return binned_confmat_plain(scores, target, thresholds, kind, num_classes, ignore_index)
    if device.type != "cuda":
        raise ValueError(f"binned_confmat takes tensors on the CPU or on one CUDA device, got"
                         f" {[scores.device, target.device, thresholds.device]}")
    _check_cuda(scores, "scores", device)
    _check_cuda(target, "target", device)
    _check_cuda(thresholds, "thresholds", device)
    n, num_thr = scores.shape[0], thresholds.numel()
    shape = (num_thr, 2, 2) if kind == "binary" else (num_thr, num_classes, 2, 2)
    if n == 0:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    plan = binned_plan(n, num_classes, num_thr, _multiprocessors(device))
    if plan.groups > 65535:
        raise ValueError(f"{num_classes} classes at {num_thr} thresholds need {plan.groups} class groups; the kernel takes 65535")
    out = torch.empty(shape, dtype=torch.float32, device=device)  # the kernel writes all of it
    stream = _stream(device)
    scratch = zeroed_scratch(device, stream, plan.head + num_classes * 2 * (num_thr + 1))
    lib = _library()
    rc = lib.tm_binned_confmat(
        scores.data_ptr(), target.data_ptr(), _TARGET_TYPES[target.dtype], BINNED_KINDS[kind], n, num_classes, num_thr,
        thresholds.data_ptr(), plan.group, plan.groups, plan.blocks, plan.shared_bytes, plan.head,
        0 if ignore_index is None else int(ignore_index), int(ignore_index is not None), scratch.data_ptr(),
        out.data_ptr(), device.index, stream,
    )
    if rc != 0:
        raise RuntimeError(f"binned_confmat kernel launch failed on the card: {lib.tm_curve_counts_error_string(rc).decode()} (cudaError {rc})")
    BINNED_CONFMAT.launches += 1
    return out


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
