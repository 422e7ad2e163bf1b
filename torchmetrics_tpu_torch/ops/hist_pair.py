"""K2, the weighted histogram pair: the wrappers of ``csrc/hist_pair.cu`` and their plain versions.

Replaces ``torchmetrics_tpu/ops/pallas_hist.py::_hist_pair_kernel`` (``:92``, entry
``hist_pair_pallas`` ``:139``). Two entries, each one launch per call on the shared-memory branch:

- :func:`hist_pair` returns the ``(2, length)`` float32 weighted histograms of an int32 or int64
  index stream under two float32 weight streams, in one pass; indices outside ``[0, length)`` are
  dropped. ``neg_w=None`` stands for a zero second stream, which the kernel then does not read
  (the weighted bincount and the weighted confusion count of ``ops/histogram.py`` use one stream).
- :func:`sketch_update` is the curve sketch's whole update: from the formatted float32 scores and
  the raw int32 or int64 target it buckets each score, forms the task's weights, drops
  ``ignore_index``, counts, and writes ``old + counts`` as the new ``(pos, neg)`` state. Its plain
  version :func:`sketch_update_plain` is the unfused chain it replaces (``score_bucket``, the
  weights, :func:`hist_pair_plain`, two adds).

Contract on order: :func:`hist_pair` adds with float atomics. With 0/1 weights each bin's sums are
integers below 2^24, exact and repeatable; general weights give sums whose last bits may differ
from run to run. :func:`sketch_update` counts integer weights in int32, exact and repeatable in
any order; as float32 its state is exact while a bucket's count stays below 2^24, as in the JAX
package.

What bounds the kernels on an H100: the HBM bytes they read, 12 or 16 B per sample for
:func:`hist_pair`, and 8 or 12 B per element plus the old and new state for
:func:`sketch_update`. On CPU tensors each entry runs its plain version; on CUDA tensors it
launches the kernel or raises, and nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from torchmetrics_tpu_torch.ops import _build
from torchmetrics_tpu_torch.ops.bincount import _INDEX_DTYPES, LaunchCounter, _check_cuda, _stream, zeroed_scratch

HIST_PAIR = LaunchCounter()
SKETCH_UPDATE = LaunchCounter()

#: the longest histogram the kernel takes: 2 * length bins must index an int
MAX_LENGTH = 2**30
#: words of scratch before :func:`hist_pair`'s cross-block sums, as ``kScratchHead`` in the source
SCRATCH_HEAD = 32
#: the fewest state words of a :func:`sketch_update` slice, as ``kMinSpan`` in the source
MIN_SLICE_WORDS = 512
#: the tasks :func:`sketch_update` takes, by their code in the source
SKETCH_KINDS = {"binary": 0, "multiclass": 1, "multiclass_micro": 2, "multilabel": 3}
_MAX_WORDS = 2**31 - 1

_SHARED_BINS: Dict[int, int] = {}
_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use, with every entry's C signature declared."""
    global _LIB
    if _LIB is None:
        lib = _build.library("hist_pair")
        c_int, c_ll, c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.tm_hist_pair.argtypes = [c_ptr, c_int, c_ptr, c_ptr, c_ll, c_int, c_ptr, c_ptr, c_int, c_ptr]
        lib.tm_hist_pair.restype = c_int
        lib.tm_sketch_update.argtypes = [
            c_ptr, c_ptr, c_int, c_int, c_ll, c_int, c_int, c_ll, c_int, c_ptr, c_ptr, c_ptr, c_int, c_ptr, c_int, c_ptr,
        ]
        lib.tm_sketch_update.restype = c_int
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
    """Bins :func:`hist_pair`'s shared-memory branch holds on ``device``; longer pairs add in global memory."""
    index = torch.device(device).index or 0
    bins = _SHARED_BINS.get(index)
    if bins is None:
        lib = _library()
        out = ctypes.c_int(0)
        _check_rc(lib, lib.tm_hist_pair_shared_bins_max(index, ctypes.byref(out)), "tm_hist_pair_shared_bins_max")
        bins = _SHARED_BINS[index] = out.value
    return bins


def branch(length: int, device: torch.device) -> str:
    """Which branch of :func:`hist_pair` a pair of ``length`` bins takes: ``shared`` or ``global``."""
    return "shared" if length <= shared_bins_max(device) else "global"


# ------------------------------------------------------------------ plain versions
def hist_pair_plain(idx: Tensor, pos_w: Tensor, neg_w: Optional[Tensor], length: int) -> Tensor:
    """Plain version of :func:`hist_pair`: remap dropped indices to a sentinel bin, then one
    ``index_add_`` of both weight streams."""
    idx = idx.reshape(-1)
    bins = torch.where((idx >= 0) & (idx < length), idx, length).to(torch.int64)
    neg = torch.zeros_like(pos_w) if neg_w is None else neg_w
    out = torch.zeros((length + 1, 2), dtype=torch.float32, device=idx.device)
    out.index_add_(0, bins, torch.stack([pos_w.reshape(-1), neg.reshape(-1)], dim=1))
    return out[:length].T.contiguous()


def score_bucket(scores: Tensor, bins: int) -> Tensor:
    """Bucket index ``clip(floor(s·(bins-1)), 0, bins-1)`` for scores in [0, 1], int32.

    The product and the floor stay in float32, as in the JAX package: in float64 a score on a
    bucket edge could move. The clip runs before the cast, so +inf lands in the last bucket and
    -inf in the first, and a NaN score lands in bucket 0, as the JAX package's cast puts it.
    """
    idx = torch.floor(scores.to(torch.float32) * (bins - 1))
    idx = torch.where(torch.isnan(idx), torch.zeros_like(idx), idx)
    return torch.clamp(idx, 0, bins - 1).to(torch.int32)


def sketch_update_plain(
    scores: Tensor, target: Tensor, pos_hist: Tensor, neg_hist: Tensor, kind: str, ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`sketch_update`: the unfused chain of the curve classes' sketch branch.

    Ignored entries get weight 0 and target 0, the target is cast to int32 (``_exact_state``), the
    task's positive mass ``pos`` is formed (the target itself, or one-vs-rest for ``multiclass``
    and ``multiclass_micro``), each score is bucketed (``score_bucket``, plus ``c·bins`` for the
    per-class tables), and ``hist_pair_plain`` of the weights ``pos·w`` and ``(1 - pos)·w`` is
    added to the old state.
    """
    bins = pos_hist.shape[-1]
    if ignore_index is None:
        weight = torch.ones(target.shape, dtype=torch.float32, device=target.device)
    else:
        ignored = target == ignore_index
        weight = (~ignored).to(torch.float32)
        target = torch.where(ignored, torch.zeros_like(target), target)
    target = target.to(torch.int32)
    idx = score_bucket(scores, bins)
    if kind in ("multiclass", "multiclass_micro"):
        num_classes = scores.shape[1]
        pos = (target[:, None] == torch.arange(num_classes, device=target.device)[None, :]).to(torch.float32)
        weight = weight[:, None]
    else:
        pos = target.to(torch.float32)
    if kind in ("multiclass", "multilabel"):
        idx = idx + torch.arange(scores.shape[1], dtype=torch.int32, device=idx.device)[None, :] * bins
    d = hist_pair_plain(idx.reshape(-1), (pos * weight).reshape(-1), ((1.0 - pos) * weight).reshape(-1),
                        pos_hist.numel())
    return pos_hist + d[0].reshape(pos_hist.shape), neg_hist + d[1].reshape(neg_hist.shape)


# ------------------------------------------------------------------ entries
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
    tensors = (idx, *weights)
    if not idx.is_cuda:
        if all(t.device.type == "cpu" for t in tensors):
            return hist_pair_plain(idx, pos_w, neg_w, length)
        raise ValueError(f"hist_pair takes tensors on the CPU or on one CUDA device, got {[t.device for t in tensors]}")
    device = idx.device
    for name, x in zip(("idx", "pos_w", "neg_w"), tensors):
        _check_cuda(x, name, device)
    if idx.numel() == 0:
        return torch.zeros((2, length), dtype=torch.float32, device=device)
    out = torch.empty((2, length), dtype=torch.float32, device=device)  # the kernel writes every bin
    stream = _stream(device)
    bins_max = _SHARED_BINS.get(device.index) or shared_bins_max(device)
    scratch = zeroed_scratch(device, stream, SCRATCH_HEAD + 2 * length) if length <= bins_max else None
    lib = _library()
    rc = lib.tm_hist_pair(
        idx.data_ptr(), int(idx.dtype == torch.int64), pos_w.data_ptr(), None if neg_w is None else neg_w.data_ptr(),
        idx.numel(), length, None if scratch is None else scratch.data_ptr(), out.data_ptr(), device.index, stream,
    )
    _check_rc(lib, rc, "hist_pair kernel launch")
    HIST_PAIR.launches += 1
    return out


@functools.lru_cache(maxsize=64)
def _sketch_layout(kind: str, scores_shape: tuple, target_shape: tuple, hist_shape: tuple) -> Tuple[int, int, int]:
    """``(samples, classes, scratch head)`` of a :func:`sketch_update` call, memoised by the shapes
    (``torch.Size`` is a tuple); raises on shapes the task does not take."""
    if kind not in SKETCH_KINDS:
        raise ValueError(f"`kind` must be one of {sorted(SKETCH_KINDS)}, got {kind!r}")
    bins = hist_shape[-1] if hist_shape else 0
    if kind == "binary":
        num_classes = 1
        ok = len(scores_shape) == 1 and target_shape == scores_shape and len(hist_shape) == 1
    else:
        num_classes = scores_shape[1] if len(scores_shape) == 2 else 0
        want_target = scores_shape if kind == "multilabel" else scores_shape[:1]
        want_hist = (bins,) if kind == "multiclass_micro" else (num_classes, bins)
        ok = len(scores_shape) == 2 and target_shape == want_target and hist_shape == want_hist
    if not ok or bins < 1 or num_classes < 1:
        raise ValueError(f"{kind}: unexpected shapes, scores {scores_shape}, target {target_shape}, histograms"
                         f" {hist_shape}")
    state = (num_classes if kind in ("multiclass", "multilabel") else 1) * bins
    slices = min(-(-state // MIN_SLICE_WORDS), 65535)
    head = SCRATCH_HEAD * -(-slices // SCRATCH_HEAD)  # a ticket for each slice there can be
    if head + 2 * state > _MAX_WORDS:
        raise ValueError(f"{num_classes} classes of {bins} bins exceed the kernel's int32 indexing")
    return scores_shape[0], num_classes, head


def sketch_update(
    scores: Tensor, target: Tensor, pos_hist: Tensor, neg_hist: Tensor, kind: str, ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """The curve sketch's update: the new ``(pos_hist, neg_hist)`` after one batch, in one launch.

    ``kind`` and shapes (``bins`` = the histograms' last axis):

    - ``"binary"``: ``(N,)`` scores and target, ``(bins,)`` histograms; positive mass ``t``,
      negative mass ``1 - t``;
    - ``"multiclass"``: ``(N, C)`` scores, an ``(N,)`` class index, ``(C, bins)`` histograms;
      one-vs-rest, ``[t == c]`` and ``[t != c]`` for class ``c``;
    - ``"multiclass_micro"``: the same one-vs-rest pairs of every class into ``(bins,)`` histograms;
    - ``"multilabel"``: ``(N, C)`` scores and targets, ``(C, bins)`` histograms; ``t`` and ``1 - t``.

    ``scores`` are float32 in [0, 1] (after ``normalize_logits_if_needed``), bucketed as
    :func:`score_bucket` does. ``target`` is int32 or int64, read in place; an entry equal to
    ``ignore_index`` adds nothing (for multiclass, the whole sample), and the others are cast to
    int32 as ``_exact_state`` casts them. The old state is read and a new one written, so the
    caller's update stays pure; the two results are the rows of one ``(2, ...)`` tensor.
    """
    n, num_classes, head = _sketch_layout(kind, scores.shape, target.shape, pos_hist.shape)
    if scores.dtype != torch.float32:
        raise TypeError(f"`scores` must be float32, got {scores.dtype}")
    if target.dtype not in _INDEX_DTYPES:
        raise TypeError(f"`target` must be int32 or int64, got {target.dtype}")
    if pos_hist.dtype != torch.float32 or neg_hist.dtype != torch.float32 or neg_hist.shape != pos_hist.shape:
        raise TypeError(f"histograms must be float32 of one shape, got {pos_hist.dtype} {tuple(pos_hist.shape)} and"
                        f" {neg_hist.dtype} {tuple(neg_hist.shape)}")
    tensors = (scores, target, pos_hist, neg_hist)
    if not scores.is_cuda:
        if all(t.device.type == "cpu" for t in tensors):
            return sketch_update_plain(scores, target, pos_hist, neg_hist, kind, ignore_index)
        raise ValueError(f"sketch_update takes tensors on the CPU or on one CUDA device, got {[t.device for t in tensors]}")
    device = scores.device
    for name, x in zip(("scores", "target", "pos_hist", "neg_hist"), tensors):
        _check_cuda(x, name, device)
    if n == 0:
        return pos_hist, neg_hist  # states are never changed in place: the old ones are the new ones
    out = torch.empty((2, *pos_hist.shape), dtype=torch.float32, device=device)  # the kernel writes all of it
    stream = _stream(device)
    scratch = zeroed_scratch(device, stream, head + out.numel())
    lib = _library()
    rc = lib.tm_sketch_update(
        scores.data_ptr(), target.data_ptr(), int(target.dtype == torch.int64), SKETCH_KINDS[kind], n, num_classes,
        pos_hist.shape[-1], 0 if ignore_index is None else int(ignore_index), int(ignore_index is not None),
        pos_hist.data_ptr(), neg_hist.data_ptr(), scratch.data_ptr(), head, out.data_ptr(), device.index, stream,
    )
    _check_rc(lib, rc, "sketch_update kernel launch")
    SKETCH_UPDATE.launches += 1
    return out.unbind(0)
