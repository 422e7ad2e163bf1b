"""Double-buffered host-to-device staging for the async ingestion tier (counterpart of
``torchmetrics_tpu/serve/staging.py``).

The JAX package stages a batch with one asynchronous ``jax.device_put``. A CUDA copy overlaps other
work only from page-locked memory and on a stream of its own, so here one staged batch is:

- its array leaves copied on the host into **pinned** buffers that the slot owns and reuses (one
  ``cudaHostAlloc`` per slot and leaf shape, not one per request);
- then ``non_blocking=True`` copies into fresh device tensors on the pipeline's own
  ``torch.cuda.Stream``, which first waits on the caller's current stream (so a device tensor the
  caller passed, or state work it issued before the enqueue, is ordered before the batch);
- then an event recorded after the copies: the drain's stream waits on it before it applies the
  batch (:meth:`StagingPipeline.ready`).

The slot, its buffers and the staged tensors stay pinned until the drain commits the batch, as in the
JAX package; before the host overwrites a slot's buffers for the next batch it waits on the slot's
previous event, so an unfinished copy is never overwritten. On the CPU a staged leaf is a copy of the
host array (a tensor the caller may not change under the drain).

- **graceful degradation**: slot exhaustion (the drain fell behind) skips staging and hands the host
  arrays through untouched (the drain's own ``update`` moves them: correctness never depends on the
  overlap); a *failed* transfer (:class:`~torchmetrics_tpu_torch.robust.chaos.StagingTransferFailure`) is
  absorbed the same way, counted in ``serve.staging_fallbacks`` with a one-shot rank-zero warning.

Values are never changed by staging: a staged leaf holds the same values in the same dtype on another
buffer, so every bit-identity contract of the engine holds with staging on or off.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor
from torch.utils._pytree import tree_flatten, tree_unflatten

from torchmetrics_tpu_torch.obs import telemetry
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn


def _stageable(leaf: Any) -> bool:
    """Array-shaped leaves move; host scalars/strings/None pass through untouched."""
    return hasattr(leaf, "shape") and hasattr(leaf, "dtype")


class _Slot:
    """One transfer-ahead slot: its pinned host buffers by leaf index, the event recorded after its last
    copies, and the staged leaves it pins until the drain commits."""

    __slots__ = ("buffers", "event", "staged")

    def __init__(self) -> None:
        self.buffers: Dict[int, Tensor] = {}
        self.event: Optional[Any] = None
        self.staged: Optional[List[Any]] = None

    def buffer(self, i: int, shape: tuple, dtype: torch.dtype) -> Tensor:
        """The slot's pinned buffer for leaf ``i``, reallocated only when the leaf's shape or dtype changed."""
        buf = self.buffers.get(i)
        if buf is None or tuple(buf.shape) != tuple(shape) or buf.dtype != dtype:
            buf = self.buffers[i] = torch.empty(shape, dtype=dtype, pin_memory=True)
        return buf


_TORCH_DTYPES: Dict[Any, torch.dtype] = {}


def _torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype of a numpy dtype; raises for a dtype torch lacks (strings, objects)."""
    out = _TORCH_DTYPES.get(dtype)
    if out is None:
        out = _TORCH_DTYPES[dtype] = torch.from_numpy(np.empty(0, dtype)).dtype
    return out


def _fill(buf: Tensor, leaf: Any) -> None:
    """Copy one host leaf into a host buffer of its shape (a numpy copy for an array, read-only ones too)."""
    if isinstance(leaf, Tensor):
        buf.copy_(leaf)
    else:
        np.copyto(buf.numpy(), leaf, casting="no")


def device_put(leaves: List[Any], device: torch.device, slot: Optional[_Slot] = None,
               stream: Optional[Any] = None) -> List[Any]:
    """Start the host-to-device copies of ``leaves``; the module-level seam the chaos harness patches
    (``StagingTransferFailure``): the pipeline always transfers through this name.

    On the CPU each leaf becomes a tensor of its own (a copy of a numpy array; a CPU tensor as it is). On
    a card: a tensor already there passes through; each host leaf is copied into ``slot``'s pinned buffer,
    then into a fresh device tensor on ``stream`` with ``non_blocking=True``, and ``slot.event`` is recorded
    after the copies.
    """
    if device.type != "cuda":
        return [leaf if isinstance(leaf, Tensor) and leaf.device == device
                else leaf.to(device=device, copy=True) if isinstance(leaf, Tensor)
                else torch.from_numpy(np.array(leaf, dtype=leaf.dtype, copy=True)) for leaf in leaves]
    current = torch.cuda.current_stream(device)
    if slot.event is not None:
        slot.event.synchronize()  # the slot's previous copies read its buffers: let them finish first
    stream.wait_stream(current)
    out: List[Any] = []
    pinned: List[Tensor] = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, Tensor) and leaf.device == device:
            out.append(leaf)
            continue
        leaf = leaf if isinstance(leaf, Tensor) else np.asarray(leaf)
        dtype = leaf.dtype if isinstance(leaf, Tensor) else _torch_dtype(leaf.dtype)
        buf = slot.buffer(i, tuple(leaf.shape), dtype)
        _fill(buf, leaf)
        pinned.append(buf)
        out.append(None)
    with torch.cuda.stream(stream):
        it = iter(pinned)
        for i, leaf in enumerate(out):
            if leaf is None:
                buf = next(it)
                dev = torch.empty(buf.shape, dtype=buf.dtype, device=device)
                dev.copy_(buf, non_blocking=True)
                out[i] = dev
        event = torch.cuda.Event()
        event.record(stream)
    slot.event = event
    return out


class StagingPipeline:
    """Bounded transfer-ahead staging: stage opportunistically, pin until committed."""

    def __init__(self, n_slots: int = 2, device: Optional[Any] = None) -> None:
        self.n_slots = max(1, int(n_slots))
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self._lock = threading.Lock()
        self._slots: Dict[int, _Slot] = {i: _Slot() for i in range(self.n_slots)}
        self._free: List[int] = list(range(self.n_slots))
        self._stream: Optional[Any] = None
        self._warned_fallback = False

    def _copy_stream(self) -> Any:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def stage(self, args: tuple, kwargs: dict) -> Tuple[tuple, dict, Optional[int]]:
        """Start the host-to-device copies for one batch; returns (args, kwargs, slot).

        ``slot`` is ``None`` when staging was skipped (no free slot) or degraded (a transfer failed);
        either way the returned batch is usable as-is.
        """
        with self._lock:
            slot = self._free.pop() if self._free else None
        if slot is None:
            telemetry.counter("serve.staging_skips").inc()
            return args, kwargs, None
        leaves, treedef = tree_flatten((args, kwargs))
        try:
            # one transfer call over the stageable leaves, as the JAX package batches its device_put
            idx = [i for i, leaf in enumerate(leaves) if _stageable(leaf)]
            stream = self._copy_stream() if self.device.type == "cuda" else None
            moved = device_put([leaves[i] for i in idx], self.device, self._slots[slot], stream) if idx else []
            staged = list(leaves)
            for i, arr in zip(idx, moved):
                staged[i] = arr
        except Exception as err:
            # transfer failure (chaos: StagingTransferFailure, or a sick device): the host batch is still
            # valid, so hand it through and let the drain's own update do the move; the serving tier
            # degrades, it does not drop data
            self.release(slot)
            telemetry.counter("serve.staging_fallbacks").inc()
            if not self._warned_fallback:
                self._warned_fallback = True
                rank_zero_warn(
                    f"Host->device staging transfer failed ({err!r}); the ingestion tier"
                    " is falling back to unstaged host batches (correct but unoverlapped).",
                    UserWarning,
                )
            return args, kwargs, None
        with self._lock:
            self._slots[slot].staged = staged  # pin: the staged tensors live until the drain commits
        telemetry.counter("serve.staged_batches").inc()
        s_args, s_kwargs = tree_unflatten(staged, treedef)
        return s_args, s_kwargs, slot

    def ready(self, slot: Optional[int]) -> Optional[Any]:
        """The event the drain's stream waits on before it applies the batch staged in ``slot``: the slot's
        copies' event, or for an unstaged batch one recorded now on the caller's current stream (which
        orders any device tensor it passed). None on the CPU."""
        if self.device.type != "cuda":
            return None
        if slot is not None:
            return self._slots[slot].event
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    def release(self, slot: Optional[int]) -> None:
        """Unpin a committed batch's slot, making it available to the next enqueue."""
        if slot is None:
            return
        with self._lock:
            self._slots[slot].staged = None
            if slot not in self._free:
                self._free.append(slot)

    @property
    def in_use(self) -> int:
        with self._lock:
            return self.n_slots - len(self._free)
