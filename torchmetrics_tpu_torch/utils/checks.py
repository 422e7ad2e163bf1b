"""Input checks (counterpart of ``torchmetrics_tpu/utils/checks.py``, reference ``checks.py:39``), and
``check_forward_full_state_property`` (``checks.py:99``)."""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import Tensor


def capturing(x: Tensor) -> bool:
    """Whether the stream of ``x``'s device is being captured into a CUDA graph, where the host
    cannot read the device: a check that reads it is skipped, as the JAX package skips host checks
    under trace."""
    return x.is_cuda and torch.cuda.is_current_stream_capturing()


def is_traced(*arrays: Any) -> bool:
    """Whether a graph capture is under way on the stream of any tensor given (``checks.py:19``). The JAX
    package answers whether an input is an abstract tracer; the port's counterpart of a trace is a CUDA-graph
    capture, where the host cannot read the device either (:func:`capturing`)."""
    return any(isinstance(a, Tensor) and capturing(a) for a in arrays)


def _check_same_shape(preds: Tensor, target: Tensor) -> None:
    """Raise if shapes differ."""
    if preds.shape != target.shape:
        raise RuntimeError(
            f"Predictions and targets are expected to have the same shape, but got {tuple(preds.shape)} and"
            f" {tuple(target.shape)}."
        )


def _not_binary(x: Tensor, ignore_index: Optional[int] = None) -> Tensor:
    bad = (x != 0) & (x != 1)
    return bad if ignore_index is None else bad & (x != ignore_index)


def _check_binary_target(target: Tensor, ignore_index: Optional[int] = None, preds: Optional[Tensor] = None) -> None:
    """Raise unless every target is 0, 1 or ``ignore_index`` and, when ``preds`` (a label tensor)
    is given, every pred is 0 or 1. One read of the device; the values are listed, as the JAX
    package lists them, only when some are not allowed."""
    flags = _not_binary(target, ignore_index).any()
    if preds is not None:
        flags = torch.stack([flags, _not_binary(preds).any()])
    bad_target, bad_preds = (bool(flags), False) if preds is None else flags.tolist()
    if bad_target:
        allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
        raise RuntimeError(
            f"Detected the following values in `target`: {sorted(torch.unique(target).tolist())} but expected only"
            f" the following values {sorted(allowed)}."
        )
    if bad_preds:
        raise RuntimeError(
            f"Detected the following values in `preds`: {sorted(torch.unique(preds).tolist())} but expected only"
            " the following values [0,1] since preds is a label tensor."
        )


def _is_integer(x: Tensor) -> bool:
    return not (x.is_floating_point() or x.is_complex() or x.dtype == torch.bool)


def _check_binary_relevance(target: Tensor, ignore_index: Optional[int] = None) -> None:
    """Raise unless every target that is not ``ignore_index`` lies in ``[0, 1]``; one read of the
    device. NaN targets pass, as they pass numpy's ``max() > 1 or min() < 0``."""
    t = target.to(torch.uint8) if target.dtype == torch.bool else target
    bad = (t > 1) | (t < 0)
    if ignore_index is not None:
        bad &= t != ignore_index
    if bool(bad.any()):
        raise ValueError("`target` must contain `binary` values")


def _check_retrieval_inputs(
    indexes: Tensor, preds: Tensor, target: Tensor, allow_non_binary_target: bool = False,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Validate and flatten retrieval triplets (``torchmetrics_tpu/utils/checks.py:54``, reference
    ``checks.py:540``). The target check reads the device once; it runs in ``update``, outside any
    graph. The JAX package skips it under trace, so a jitted update there accepts a target of 2."""
    if indexes.shape != preds.shape or preds.shape != target.shape:
        raise ValueError("`indexes`, `preds` and `targets` must be of the same shape")
    if not _is_integer(indexes):
        raise ValueError("`indexes` must be a tensor of long integers")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    indexes, preds, target = indexes.reshape(-1), preds.reshape(-1), target.reshape(-1)
    if not allow_non_binary_target and target.numel() and not capturing(target):
        _check_binary_relevance(target, ignore_index)
    return indexes, preds, target


def _check_retrieval_functional_inputs(
    preds: Tensor, target: Tensor, allow_non_binary_target: bool = False
) -> Tuple[Tensor, Tensor]:
    """Validate and flatten one query's ``(preds, target)`` (``torchmetrics_tpu/utils/checks.py:75``)."""
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must be of the same shape")
    if not preds.is_floating_point():
        raise ValueError("`preds` must be a tensor of floats")
    preds, target = preds.reshape(-1), target.reshape(-1)
    if not allow_non_binary_target and target.numel() and not capturing(target):
        _check_binary_relevance(target)
    return preds, target


def _allclose_recursive(res1: Any, res2: Any, atol: float = 1e-6) -> bool:
    """Elementwise closeness over nested dict/sequence results (``checks.py:90``, reference ``checks.py:614``)."""
    if isinstance(res1, dict):
        return all(_allclose_recursive(res1[k], res2[k], atol) for k in res1)
    if isinstance(res1, (list, tuple)):
        return all(_allclose_recursive(r1, r2, atol) for r1, r2 in zip(res1, res2))
    as_np = lambda r: r.detach().cpu().numpy() if isinstance(r, Tensor) else np.asarray(r)
    return bool(np.allclose(as_np(res1), as_np(res2), atol=atol))


def _wait(values: Any) -> None:
    """Wait for the card to finish the work behind ``values`` (the JAX package's ``block_until_ready``)."""
    if any(isinstance(v, Tensor) and v.is_cuda for v in values):
        torch.cuda.synchronize()


def check_forward_full_state_property(
    metric_class: Any,
    init_args: Optional[dict] = None,
    input_args: Optional[dict] = None,
    num_update_to_compare: Tuple[int, ...] = (10, 100, 1000),
    reps: int = 5,
) -> None:
    """Profile whether a metric can safely run the reduce-state ``forward`` (``checks.py:99``, reference
    ``checks.py:636``): the full-state against the reduce-state ``forward``, their agreement and their times, and
    the fused ``update_batches`` against the per-batch ``update`` loop, printed as the JAX package prints them.
    Pass ``init_args={"device": "cpu"}`` to profile on the host."""
    import time

    init_args = init_args or {}
    input_args = input_args or {}

    class FullState(metric_class):
        full_state_update = True

    class PartState(metric_class):
        full_state_update = False

    fullstate = FullState(**init_args)
    partstate = PartState(**init_args)

    equal = True
    try:  # failure usually means update needs access to the full accumulated state
        for _ in range(num_update_to_compare[0]):
            equal = equal and _allclose_recursive(fullstate(**input_args), partstate(**input_args))
        res1 = fullstate.compute()
        res2 = partstate.compute()
        equal = equal and _allclose_recursive(res1, res2)
    except Exception:
        equal = False

    if not equal:
        print("Recommended setting `full_state_update=True`")
        return

    timings = np.zeros((2, len(num_update_to_compare), reps))
    for i, metric in enumerate((fullstate, partstate)):
        for j, steps in enumerate(num_update_to_compare):
            for r in range(reps):
                metric.reset()
                start = time.perf_counter()
                for _ in range(steps):
                    out = metric(**input_args)
                _wait([out])
                timings[i, j, r] = time.perf_counter() - start
            label = "Full" if i == 0 else "Partial"
            print(f"{label} state for {steps} steps took: {timings[i, j].mean():.4f}s")

    # fused update_batches sweep against the per-batch loop
    try:
        stacked = {k: torch.stack([torch.as_tensor(v)] * num_update_to_compare[0]) for k, v in input_args.items()}
        metric = PartState(**init_args)
        metric.update_batches(**stacked)  # the first sweep captures its graph
        metric.reset()
        start = time.perf_counter()
        metric.update_batches(**stacked)
        _wait(list(metric._state.tensors.values()))
        scan_time = time.perf_counter() - start
        metric.reset()
        start = time.perf_counter()
        for _ in range(num_update_to_compare[0]):
            metric.update(**input_args)
        _wait(list(metric._state.tensors.values()))
        loop_time = time.perf_counter() - start
        print(
            f"Fused update_batches for {num_update_to_compare[0]} steps took: {scan_time:.4f}s"
            f" vs per-batch loop {loop_time:.4f}s ({loop_time / max(scan_time, 1e-9):.1f}x)"
        )
    except Exception as err:
        print(f"update_batches sweep unavailable for this metric: {err!r}")

    faster = bool(timings[1].sum() < timings[0].sum())
    print(f"Recommended setting `full_state_update={not faster}`")
