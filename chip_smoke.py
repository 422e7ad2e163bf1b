#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card, check it, and time its kernel.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``torchmetrics_tpu_torch/csrc`` (one ``nvcc`` per source,
all started together) and then:

1. holds kernel K1 (``csrc/bincount.cu``) against its plain PyTorch version on the card, for
   both of its loaders and both output dtypes (int32, int64), with exact equality; then K1, K2
   and K3 calls twice in a row and on two streams, and one call of each K1, K3 and K2 entry
   captured in a CUDA graph and replayed three times;
2. path A, the benchmark's headline (``bench.py``): the four-metric multiclass collection at
   C = 5 over 1,000,000 int32 labels in 100 ``forward`` calls of 10,000, then ``compute()``;
3. path B, shaped like ImageNet validation: C = 1000 over 50,000 float32 logit rows in 50
   batches of 1,000, with ``ignore_index=-1`` on 1% of the targets; its 1M-bin confusion count
   takes the kernel's global-memory branch;
4. times K1 with CUDA events beside its bound, its plain version and ``torch.bincount``, and
   splits one wrapper call into allocation, the ctypes call and device time;
5. holds kernels K3 (``csrc/curve_counts.cu``) and K2 (``csrc/hist_pair.cu``) against their plain
   versions: exact for 0/1 weights, within rtol 1e-5 for general ones, K3 bitwise repeatable; K3's
   binned entry bitwise equal to its direct body on 0/1 inputs; and K2's fused sketch entry
   ``sketch_update`` equal to its plain version (the unfused chain) for every task;
6. path C, BASELINE config #3 (``bench.py:2137-2170``, seed 5): binary AUROC and AP at
   ``thresholds=200`` over 1,000,000 scores, multiclass and multilabel AUROC at C = 5 over
   200,000 rows, and ``MetricCollection([BinaryAUROC, BinaryAveragePrecision])`` at 200
   thresholds through 100 ``forward`` calls of 10,000;
7. path D, the streaming curve sketch (``bench.py:720-790,833-836``, seed 17):
   ``BinaryAUROC(approx="sketch", sketch_bins=2048)`` over 16 batches of 65,536, and
   ``MulticlassAUROC(num_classes=5, approx="sketch")`` over 200,000 rows, one ``sketch_update``
   launch per update;
8. times K3 (the binned entry, and beside it the direct body it replaced on the metric path) and
   K2 (``hist_pair``, and ``sketch_update`` beside the unfused chain it replaced) at the paths'
   shapes and at N = 2^26, beside their bounds, plain versions and library calls.

Counts must equal numpy's (``np.bincount``, or a compare-and-sum over the thresholds) exactly;
stat-score values the numpy formulas within 1e-6, curve values a float64 numpy evaluation of the
same binned formulas within 1e-5, and the sketch's AUROC exact mode's within
``auroc_error_bound(2048)``. Every check raises, so a failed phase ends the run with a non-zero
exit. The last line is ``{"ok": true, "device": {...}}``; the line before it lists the kernels.
Without a CUDA device, or without the package beside it, the script exits non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# NVIDIA H100 SXM data sheet: HBM bandwidth, and the float32 rate outside the tensor cores,
# the nearest published rate for the kernel's scalar int32 adds
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
TOL = 1e-6
CURVE_TOL = 1e-5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int) -> float:
    """Mean host microseconds per call of ``fn``: the card is synchronised before and after the
    loop, not inside it, so this is what the host spends issuing one call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e6


def device_profile(fn, kernels, calls: int = 200):
    """Device microseconds per call of ``fn`` spent in the kernels named ``kernels``, and the
    device operations per call, from ``torch.profiler``."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_us = sum(e.time_range.end - e.time_range.start for e in ops if any(k in e.name for k in kernels))
    return kernel_us / calls, len(ops) / calls


def wrapper_split(card: str, label: str, wrapper, alloc, raw_call, kernels, iters: int = 2000) -> None:
    """Split one wrapper call: the host's cost of the whole wrapper, of its output allocation alone
    and of the bare ctypes call (the launch included), and the kernel's own device time and the
    device operations per call."""
    whole, alloc_us, call_us = host_us(wrapper, iters), host_us(alloc, iters), host_us(raw_call, iters)
    kernel_us, ops = device_profile(wrapper, kernels)
    print(f"split [{card}] {label}: wrapper {whole:.2f} us of host time = output allocation {alloc_us:.2f}"
          f" + ctypes call and launch {call_us:.2f} + checks and scratch lookup {whole - alloc_us - call_us:.2f};"
          f" on the device {kernel_us:.2f} us in the kernel, {ops:.1f} device operations per call")


def bound(n_bytes: int, n_ops: int):
    """Least time in ms for the work, and what sets it."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_checks(k1, device, dtype):
    """K1 against its plain version on the card, both loaders, counts in ``dtype``, exact.
    Returns (cases, max abs error)."""
    errors = []

    def check(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: kernel gives {got.dtype} {tuple(got.shape)}, plain {want.dtype} {tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item()) if got.numel() else 0
        if err:
            raise AssertionError(f"{name}: kernel differs from its plain version by up to {err}")
        errors.append(err)

    gen = np.random.RandomState(1)
    bins_max = k1.shared_bins_max(device)
    out = dtype
    for dtype in (torch.int32, torch.int64):
        empty = torch.empty(0, dtype=dtype, device=device)
        check(f"bincount N=0 {dtype}", k1.bincount(empty, 25, out), k1.bincount_plain(empty, 25, out))
        for length in (1, 25, 1000, 40_000, bins_max, bins_max + 1, 1_000_000):
            for n in (1, 4097, 1_000_003):
                x = gen.randint(-3, length + 3, n).astype(np.int64)
                if dtype == torch.int64:
                    x[::5] += 2**31  # above int32: must be dropped, never wrapped into a bin
                    x[1::7] = -(2**40)
                xt = torch.from_numpy(x).to(device=device, dtype=dtype)
                check(f"bincount n={n} length={length} {dtype}", k1.bincount(xt, length, out),
                      k1.bincount_plain(xt, length, out))
    big = torch.from_numpy(gen.randint(0, 25, 2**26).astype(np.int32)).to(device)
    check("bincount N=2^26 length=25", k1.bincount(big, 25, out), k1.bincount_plain(big, 25, out))
    for pd, td in ((torch.int32, torch.int32), (torch.int64, torch.int32), (torch.int32, torch.int64), (torch.int64, torch.int64)):
        empty_p = torch.empty(0, dtype=pd, device=device)
        empty_t = torch.empty(0, dtype=td, device=device)
        check("confusion N=0", k1.confusion_counts(empty_p, empty_t, 5, dtype=out),
              k1.confusion_counts_plain(empty_p, empty_t, 5, dtype=out))
        for c in (2, 5, 37, 1000, 1100):
            for n in (7, 10_000, 1_000_003):
                p = gen.randint(-1, c + 1, n).astype(np.int64)
                t = gen.randint(-1, c + 1, n).astype(np.int64)
                if td == torch.int64:
                    t[::11] += 2**32
                pt = torch.from_numpy(p).to(device=device, dtype=pd)
                tt = torch.from_numpy(t).to(device=device, dtype=td)
                mask = torch.from_numpy(gen.rand(n) < 0.9).to(device)
                for kw in ({}, {"ignore_index": 0}, {"ignore_index": -1, "mask": mask}):
                    check(f"confusion C={c} n={n} {pd}/{td} {sorted(kw)}",
                          k1.confusion_counts(pt, tt, c, **kw, dtype=out), k1.confusion_counts_plain(pt, tt, c, **kw, dtype=out))
    big_p = torch.from_numpy(gen.randint(0, 5, 2**26).astype(np.int32)).to(device)
    big_t = big % 5
    check("confusion N=2^26 C=5", k1.confusion_counts(big_p, big_t, 5, dtype=out),
          k1.confusion_counts_plain(big_p, big_t, 5, dtype=out))
    torch.cuda.synchronize()
    return len(errors), max(errors)


def scratch_checks(k1, k3, k2, device) -> int:
    """The cross-block scratch is left clean: two calls in a row, calls on two streams, and one call
    of K1, K3, K2's ``hist_pair`` and K2's ``sketch_update`` captured in a CUDA graph and replayed
    three times, each checked against the plain version. Returns the number of checks."""
    rng = np.random.RandomState(6)
    checks = 0

    def expect(name, got, want):
        nonlocal checks
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel differs from its plain version")
        checks += 1

    x = torch.from_numpy(rng.randint(0, 25, 1_000_003).astype(np.int32)).to(device)
    want = k1.bincount_plain(x, 25, torch.int64)
    for i in range(2):
        expect(f"K1 call {i} in a row", k1.bincount(x, 25, torch.int64), want)
    streams = [torch.cuda.Stream(device) for _ in range(2)]
    outs = []
    for _ in range(3):
        for stream in streams:
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                outs.append(k1.bincount(x, 25, torch.int64))
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        expect(f"K1 on stream {i % 2}, round {i // 2}", got, want)

    bins = 2048
    s2 = torch.from_numpy(rng.rand(1_000_003).astype(np.float32)).to(device)
    t2 = torch.from_numpy(rng.randint(0, 2, 1_000_003).astype(np.int32)).to(device)
    old = (torch.ones(bins, device=device), torch.zeros(bins, device=device))
    idx2 = torch.from_numpy(rng.randint(0, bins, 1_000_003).astype(np.int32)).to(device)
    w2 = (t2 == 1).float()
    want_sketch = torch.stack(k2.sketch_update_plain(s2, t2, *old, "binary"))
    want_pair = k2.hist_pair_plain(idx2, w2, 1.0 - w2, bins)
    for i in range(2):
        expect(f"K2 sketch_update call {i} in a row", torch.stack(k2.sketch_update(s2, t2, *old, "binary")), want_sketch)
        expect(f"K2 hist_pair call {i} in a row", k2.hist_pair(idx2, w2, 1.0 - w2, bins), want_pair)
    outs = []
    for _ in range(3):
        for stream in streams:
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                outs.append((k2.sketch_update(s2, t2, *old, "binary"), k2.hist_pair(idx2, w2, 1.0 - w2, bins)))
    torch.cuda.synchronize()
    for i, (sketch, pair) in enumerate(outs):
        expect(f"K2 sketch_update on stream {i % 2}, round {i // 2}", torch.stack(sketch), want_sketch)
        expect(f"K2 hist_pair on stream {i % 2}, round {i // 2}", pair, want_pair)

    n = 100_000
    preds = torch.from_numpy(rng.randint(0, 5, n).astype(np.int32)).to(device)
    target = torch.from_numpy(rng.randint(0, 5, n).astype(np.int32)).to(device)
    scores = torch.from_numpy(rng.rand(n).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.randint(0, 2, n).astype(np.int32)).to(device)
    thr = torch.from_numpy(np.linspace(0, 1, 200, dtype=np.float32)).to(device)
    mc_scores = torch.from_numpy(rng.rand(n, 5).astype(np.float32)).to(device)
    mc_old = (torch.zeros((5, bins), device=device), torch.ones((5, bins), device=device))
    w = (labels == 1).float()

    def captured():
        return (k1.confusion_counts(preds, target, 5, dtype=torch.int64), k3.binned_confmat(scores, labels, thr, "binary"),
                k2.hist_pair(preds, w, 1.0 - w, 5), torch.stack(k2.sketch_update(mc_scores, target, *mc_old, "multiclass", 0)))

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        captured()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cm, curve, pair, sketch = captured()
    for step in range(3):
        preds.copy_(torch.from_numpy(rng.randint(0, 5, n).astype(np.int32)))
        scores.copy_(torch.from_numpy(rng.rand(n).astype(np.float32)))
        mc_scores.copy_(torch.from_numpy(rng.rand(n, 5).astype(np.float32)))
        graph.replay()
        torch.cuda.synchronize()
        expect(f"K1 graph replay {step}", cm, k1.confusion_counts_plain(preds, target, 5, dtype=torch.int64))
        expect(f"K3 graph replay {step}", curve, k3.binned_confmat_plain(scores, labels, thr, "binary"))
        expect(f"K2 hist_pair graph replay {step}", pair, k2.hist_pair_plain(preds, w, 1.0 - w, 5))
        expect(f"K2 sketch_update graph replay {step}", sketch,
               torch.stack(k2.sketch_update_plain(mc_scores, target, *mc_old, "multiclass", 0)))
    return checks


def collection(num_classes: int, **kwargs):
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import (
        MulticlassAccuracy,
        MulticlassF1Score,
        MulticlassPrecision,
        MulticlassRecall,
    )

    return MetricCollection([
        MulticlassAccuracy(num_classes=num_classes, average="micro", **kwargs),
        MulticlassPrecision(num_classes=num_classes, average="macro", **kwargs),
        MulticlassRecall(num_classes=num_classes, average="macro", **kwargs),
        MulticlassF1Score(num_classes=num_classes, average="macro", **kwargs),
    ])


def reference_values(preds: np.ndarray, target: np.ndarray, num_classes: int, ignore_index=None):
    """Confusion counts and metric values from numpy alone."""
    keep = np.ones(target.shape, bool) if ignore_index is None else target != ignore_index
    cm = np.bincount(target[keep] * num_classes + preds[keep], minlength=num_classes**2).reshape(num_classes, num_classes)
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    tn = cm.sum() - tp - fp - fn
    present = (tp + fp + fn) > 0

    def macro(num, den):
        score = np.divide(num, den, out=np.zeros_like(num), where=den > 0)
        return score[present].mean() if present.any() else 0.0

    values = {
        "MulticlassAccuracy": tp.sum() / max(tp.sum() + fn.sum(), 1),
        "MulticlassPrecision": macro(tp, tp + fp),
        "MulticlassRecall": macro(tp, tp + fn),
        "MulticlassF1Score": macro(2 * tp, 2 * tp + fn + fp),
    }
    return {"tp": tp, "fp": fp, "tn": tn, "fn": fn}, values


def check_path(name: str, mc, preds: np.ndarray, target: np.ndarray, num_classes: int, last_batch, ignore_index=None):
    counts, values = reference_values(preds, target, num_classes, ignore_index)
    result = mc.compute()
    for member in mc.values():
        state = member.metric_state
        for key, want in counts.items():
            got = state[key].cpu().numpy()
            if not np.array_equal(got, want):
                raise AssertionError(f"{name}: {type(member).__name__}.{key} differs from np.bincount")
    for key, want in values.items():
        got = float(result[key])
        if not np.isfinite(got) or abs(got - want) > TOL:
            raise AssertionError(f"{name}: {key} = {got}, numpy gives {want}")
    batch_vals, batch_p, batch_t = last_batch
    _, want_batch = reference_values(batch_p, batch_t, num_classes, ignore_index)
    for key, want in want_batch.items():
        got = float(batch_vals[key])
        if abs(got - want) > TOL:
            raise AssertionError(f"{name}: last batch {key} = {got}, numpy gives {want}")
    if list(mc.compute_groups.values()) != [list(values)]:
        raise AssertionError(f"{name}: expected one compute group of all four metrics, got {mc.compute_groups}")
    return {k: float(result[k]) for k in values}


def run_path(name, mc, k1, preds_dev, target_dev, batch: int):
    """Drive ``forward`` over the batches with K1's count set to 0 just before; returns
    (last batch values, seconds, launches)."""
    n_batches = target_dev.shape[0] // batch
    torch.cuda.synchronize()
    k1.BINCOUNT.launches = 0
    t0 = time.perf_counter()
    for i in range(n_batches):
        vals = mc(preds_dev[i * batch:(i + 1) * batch], target_dev[i * batch:(i + 1) * batch])
    mc.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = k1.BINCOUNT.launches
    if launches < n_batches:
        raise AssertionError(f"{name}: K1 launched {launches} times over {n_batches} forward calls")
    return vals, seconds, launches

def curve_kernel_checks(k3, k2, device):
    """K3 and K2 against their plain versions on the card: exact for 0/1 weights, within rtol 1e-5
    for general ones; K3 run twice on each input must agree bit for bit. Returns, per kernel, the
    number of comparisons and the largest absolute difference."""
    cases = {"K3": 0, "K2": 0}
    errors = {"K3": 0.0, "K2": 0.0}

    def compare(kernel: str, name: str, got: torch.Tensor, want: torch.Tensor, exact: bool) -> None:
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name}: kernel gives {got.dtype} {tuple(got.shape)}, plain {want.dtype} {tuple(want.shape)}")
        err = float((got.double() - want.double()).abs().max().item()) if got.numel() else 0.0
        if exact and err:
            raise AssertionError(f"{name}: kernel differs from its plain version by up to {err}")
        if not exact:
            torch.testing.assert_close(got, want, rtol=CURVE_TOL, atol=CURVE_TOL, msg=lambda m: f"{name}: {m}")
        cases[kernel] += 1
        errors[kernel] = max(errors[kernel], err)

    gen = np.random.RandomState(3)

    def weights(shape, kind):
        if kind == "binary":
            pos = (gen.rand(*shape) < 0.4).astype(np.float32)
            return pos, ((1 - pos) * (gen.rand(*shape) < 0.9)).astype(np.float32)
        return gen.rand(*shape).astype(np.float32), gen.rand(*shape).astype(np.float32)

    for num_classes in (1, 5, 1000):
        for n in (0, 1, 4097, 1_000_003):
            if num_classes * n > 6_000_000:
                continue  # C = 1000 runs up to N = 4097: its plain version forms C * chunk * T compares
            for num_thr in (1, 200, 2048):
                thr = np.linspace(0.0, 1.0, num_thr, dtype=np.float32)
                scores = gen.rand(num_classes, n).astype(np.float32)
                if n >= 8:  # scores on a threshold, and NaN and +-inf, which count nowhere or everywhere
                    on = gen.randint(0, n, n // 10 + 1)
                    scores[:, on] = thr[gen.randint(0, num_thr, on.size)]
                    scores[0, 1], scores[0, 3], scores[-1, 5] = np.nan, np.inf, -np.inf
                for kind in ("binary", "general"):
                    if kind == "general" and n > 4097:
                        continue  # float32 sums of 1M terms differ by more than 1e-5 between two orders
                    pos, neg = weights(scores.shape, kind)
                    args = [torch.from_numpy(a).to(device) for a in (scores, pos, neg, thr)]
                    tp, fp = k3.curve_counts(*args)
                    tp2, fp2 = k3.curve_counts(*args)
                    name = f"K3 C={num_classes} N={n} T={num_thr} {kind}"
                    if not (torch.equal(tp, tp2) and torch.equal(fp, fp2)):
                        raise AssertionError(f"{name}: two runs on one input differ")
                    ptp, pfp = k3.curve_counts_plain(*args)
                    compare("K3", name + " tp", tp, ptp, kind == "binary")
                    compare("K3", name + " fp", fp, pfp, kind == "binary")
    bins_max = k2.shared_bins_max(device)
    for length in (1, 2048, 10_240, bins_max, bins_max + 1, 2_048_000):  # shared and global branches
        for dtype in (torch.int32, torch.int64):
            for n in (0, 7, 65_536, 1_000_003):
                for kind in ("binary", "general"):
                    if kind == "general" and n > 64 * length:
                        continue  # float atomics: long sums in one bin differ by more than 1e-5 between orders
                    idx = gen.randint(-3, length + 3, n).astype(np.int64)
                    if dtype == torch.int64:
                        idx[::5] += 2**31  # above int32: dropped, never wrapped into a bin
                    pos, neg = weights((n,), kind)
                    args = [torch.from_numpy(idx).to(device=device, dtype=dtype),
                            torch.from_numpy(pos).to(device), torch.from_numpy(neg).to(device)]
                    compare("K2", f"K2 length={length} N={n} {dtype} {kind}", k2.hist_pair(*args, length),
                            k2.hist_pair_plain(*args, length), kind == "binary")
                    if kind == "binary" and n == 65_536:
                        compare("K2", f"K2 one stream length={length} {dtype}", k2.hist_pair(args[0], args[1], None, length),
                                k2.hist_pair_plain(args[0], args[1], None, length), True)
    torch.cuda.synchronize()
    return cases, errors


def sketch_checks(k2, device):
    """K2's fused ``sketch_update`` against its plain version (the unfused chain) on the card, exactly:
    every task (binary; multiclass, micro and multilabel at C = 5 and at C = 20, two class groups),
    N from 1 to 1,000,003 and 2^26 (binary), 2 and 2048 bins and 40,000 (a class wider than shared
    memory, cut into slices), scores on bucket edges and NaN, +-inf, int32 and int64 targets, ``ignore_index`` on
    15%, and targets of 2 and -3 (``validate_args=False``). Returns the number of cases."""
    gen = np.random.RandomState(8)
    cases = 0

    def check(name, args, kind, ignore_index):
        nonlocal cases
        got = k2.sketch_update(*args, kind, ignore_index)
        want = k2.sketch_update_plain(*args, kind, ignore_index)
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: sketch_update differs from its plain version by up to"
                                     f" {float((g - w).abs().max())}")
        cases += 1

    sizes = ((1, 2), (4097, 2), (10_000, 2048), (65_536, 2048), (1_000_003, 2048), (5000, 40_000))
    for kind, classes in (("binary", 1), ("multiclass", 5), ("multiclass", 20), ("multiclass_micro", 5),
                          ("multiclass_micro", 20), ("multilabel", 5), ("multilabel", 20)):
        for n, bins in sizes:
            shape = (n,) if kind == "binary" else (n, classes)
            scores = gen.rand(*shape).astype(np.float32)
            flat = scores.reshape(-1)
            edges = np.arange(bins, dtype=np.float32) / np.float32(bins - 1)
            on = gen.randint(0, flat.size, flat.size // 4)
            flat[on] = edges[gen.randint(0, bins, on.size)]
            special = np.array([np.nan, np.inf, -np.inf, -0.5, 1.5], np.float32)[:flat.size]
            flat[:special.size] = special
            labels = (0, 1, 2, -3) if n == 4097 and kind in ("binary", "multilabel") else (0, 1)
            if kind in ("multiclass", "multiclass_micro"):
                target = gen.randint(0, classes, n)
            else:
                target = np.asarray(labels)[gen.randint(0, len(labels), shape)]
            hist_shape = (classes, bins) if kind in ("multiclass", "multilabel") else (bins,)
            old = [torch.from_numpy(gen.randint(0, 50, hist_shape).astype(np.float32)).to(device) for _ in range(2)]
            dev_scores = torch.from_numpy(scores).to(device)
            for ignore_index in (None, -1):
                t = target.copy()
                if ignore_index is not None:
                    t[gen.rand(*t.shape) < 0.15] = ignore_index
                for dtype in (torch.int32, torch.int64):
                    args = (dev_scores, torch.from_numpy(t).to(device=device, dtype=dtype), *old)
                    check(f"K2 sketch_update {kind} C={classes} N={n} bins={bins} {dtype} ignore={ignore_index}",
                          args, kind, ignore_index)
    big = torch.rand(2**26, device=device, generator=torch.Generator(device).manual_seed(9))
    big_t = (torch.rand(2**26, device=device, generator=torch.Generator(device).manual_seed(10)) < big).int()
    zero = torch.zeros(2048, device=device)
    check("K2 sketch_update binary N=2^26 bins=2048", (big, big_t, zero, zero), "binary", None)
    torch.cuda.synchronize()
    return cases


def binned_checks(k3, device):
    """K3's binned entry against its direct body on 0/1 inputs (the direct body's own cases: C = 1, 5, 1000,
    N = 0 to 1,000,003, T = 1, 200, 2048, scores on thresholds, NaN and +-inf, ``ignore_index``
    on a third of the targets), bitwise, and against its own plain version. Returns (cases,
    largest absolute difference)."""
    gen = np.random.RandomState(3)
    cases = 0
    for num_classes in (1, 5, 1000):
        for n in (0, 1, 4097, 1_000_003):
            if num_classes * n > 6_000_000:
                continue
            for num_thr in (1, 200, 2048):
                thr_np = np.linspace(0.0, 1.0, num_thr, dtype=np.float32)
                scores_np = gen.rand(n, num_classes).astype(np.float32)
                if n >= 8:
                    on = gen.randint(0, n, n // 10 + 1)
                    scores_np[on, :] = thr_np[gen.randint(0, num_thr, on.size)][:, None]
                    scores_np[1, 0], scores_np[3, 0], scores_np[5, -1] = np.nan, np.inf, -np.inf
                thr = torch.from_numpy(thr_np).to(device)
                for kind in (("binary", "multilabel") if num_classes == 1 else ("multiclass", "multilabel")):
                    t_np = gen.randint(-1, num_classes, n) if kind == "multiclass" else gen.randint(-1, 2, (n, num_classes))
                    s_np = scores_np[:, 0] if kind == "binary" else scores_np
                    t_np = (t_np[:, 0] if kind == "binary" else t_np).astype(np.int32)
                    scores = torch.from_numpy(np.ascontiguousarray(s_np)).to(device)
                    target = torch.from_numpy(np.ascontiguousarray(t_np)).to(device)
                    name = f"K3 binned C={num_classes} N={n} T={num_thr} {kind}"
                    out = k3.binned_confmat(scores, target, thr, kind, num_classes, ignore_index=-1)
                    t = (target[:, None] if target.ndim == 1 else target).long()
                    kept = t != -1
                    if kind == "multiclass":
                        classes = torch.arange(num_classes, device=device)[None, :]
                        pos, neg = (t == classes) & kept, (t != classes) & kept
                    else:
                        pos, neg = (t == 1) & kept, (t == 0) & kept
                    pos, neg = pos.T.float().contiguous(), neg.T.float().contiguous()
                    rows = (scores[:, None] if scores.ndim == 1 else scores).T.contiguous()
                    tp, fp = k3.curve_counts(rows, pos, neg, thr)
                    direct = torch.stack([torch.stack([neg.sum(1)[None, :] - fp.T, fp.T], -1),
                                          torch.stack([pos.sum(1)[None, :] - tp.T, tp.T], -1)], -2)
                    got = out.reshape(direct.shape)
                    if not torch.equal(got, direct):
                        diff = float((got.double() - direct.double()).abs().max())
                        raise AssertionError(f"{name}: binned entry differs from the direct body by up to {diff}")
                    plain = k3.binned_confmat_plain(scores, target, thr, kind, num_classes, -1)
                    if not torch.equal(out, plain):
                        raise AssertionError(f"{name}: binned entry differs from its plain version")
                    cases += 1
    torch.cuda.synchronize()
    return cases


def threshold_counts_np(scores: np.ndarray, positive: np.ndarray, thr: np.ndarray):
    """float64 ``(tp, fp)`` at each threshold of 0/1 ``positive`` labels: a numpy compare and sum."""
    tp = np.zeros(thr.size)
    fp = np.zeros(thr.size)
    for i in range(0, scores.size, 50_000):
        hit = scores[i:i + 50_000, None] >= thr[None, :]
        pos = positive[i:i + 50_000].astype(bool)
        tp += hit[pos].sum(0)
        fp += hit[~pos].sum(0)
    return tp, fp


def binned_values_np(tp: np.ndarray, fp: np.ndarray, n_pos: float, n_neg: float):
    """float64 AUROC and AP of the binned formulas (``roc.py::_roc_from_confmat``,
    ``average_precision.py::_ap_from_curve``) from per-threshold counts."""
    def div(a, b):
        return np.divide(a, b, out=np.zeros_like(a), where=b != 0)

    fn, tn = n_pos - tp, n_neg - fp
    tpr, fpr = div(tp, tp + fn)[::-1], div(fp, fp + tn)[::-1]
    auroc = float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2))
    precision = np.r_[div(tp, tp + fp), 1.0]
    recall = np.r_[div(tp, tp + fn), 0.0]
    return auroc, float(-np.sum((recall[1:] - recall[:-1]) * precision[:-1]))


def check_value(name: str, got, want: float, tol: float = CURVE_TOL) -> float:
    got = float(got)
    if not np.isfinite(got) or abs(got - want) > tol:
        raise AssertionError(f"{name} = {got}, numpy gives {want} (tolerance {tol})")
    return got


def check_confmat(name: str, confmat: torch.Tensor, tp: np.ndarray, fp: np.ndarray, n_pos: float, n_neg: float) -> None:
    """A ``(T, 2, 2)`` confusion state against numpy's counts, exactly."""
    cm = confmat.double().cpu().numpy()
    for label, got, want in (("tp", cm[:, 1, 1], tp), ("fp", cm[:, 0, 1], fp), ("fn", cm[:, 1, 0], n_pos - tp),
                             ("tn", cm[:, 0, 0], n_neg - fp)):
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: {label} differs from numpy's count by up to {np.abs(got - want).max()}")


def run_path_c(device, k3):
    """Path C, BASELINE config #3 at bench.py's shapes. Returns (summary, K3 launches)."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import (
        BinaryAUROC,
        BinaryAveragePrecision,
        MulticlassAUROC,
        MultilabelAUROC,
    )
    from torchmetrics_tpu_torch.functional import (
        binary_auroc,
        binary_average_precision,
        multiclass_auroc,
        multilabel_auroc,
    )

    num_thr, num_classes, total, batch = 200, 5, 1_000_000, 10_000
    rng = np.random.RandomState(5)  # bench.py:2150-2156, in its order
    b_preds = rng.rand(total).astype(np.float32)
    b_target = rng.randint(0, 2, size=total).astype(np.int32)
    mc_preds = rng.rand(total // 5, num_classes).astype(np.float32)
    mc_target = rng.randint(0, num_classes, size=total // 5).astype(np.int32)
    ml_target = rng.randint(0, 2, size=(total // 5, num_classes)).astype(np.int32)
    dev = {k: torch.from_numpy(v).to(device) for k, v in
           (("bp", b_preds), ("bt", b_target), ("mp", mc_preds), ("mt", mc_target), ("lt", ml_target))}
    thr = np.linspace(0.0, 1.0, num_thr, dtype=np.float32)

    # numpy's counts and the float64 values of the binned formulas
    b_tp, b_fp = threshold_counts_np(b_preds, b_target, thr)
    b_pos = float(b_target.sum())
    b_auroc, b_ap = binned_values_np(b_tp, b_fp, b_pos, total - b_pos)
    per_class = [threshold_counts_np(mc_preds[:, c], mc_target == c, thr) for c in range(num_classes)]
    mc_pos = [float((mc_target == c).sum()) for c in range(num_classes)]
    mc_auroc = np.mean([binned_values_np(tp, fp, p, total // 5 - p)[0] for (tp, fp), p in zip(per_class, mc_pos)])
    per_label = [threshold_counts_np(mc_preds[:, c], ml_target[:, c], thr) for c in range(num_classes)]
    ml_pos = [float(ml_target[:, c].sum()) for c in range(num_classes)]
    ml_auroc = np.mean([binned_values_np(tp, fp, p, total // 5 - p)[0] for (tp, fp), p in zip(per_label, ml_pos)])

    torch.cuda.synchronize()
    k3.BINNED_CONFMAT.launches = 0
    k3.CURVE_COUNTS.launches = 0
    t0 = time.perf_counter()
    values = {
        "binary_auroc": binary_auroc(dev["bp"], dev["bt"], thresholds=num_thr, validate_args=False),
        "binary_average_precision": binary_average_precision(dev["bp"], dev["bt"], thresholds=num_thr, validate_args=False),
        "multiclass_auroc": multiclass_auroc(dev["mp"], dev["mt"], num_classes, thresholds=num_thr, validate_args=False),
        "multilabel_auroc": multilabel_auroc(dev["mp"], dev["lt"], num_classes, thresholds=num_thr, validate_args=False),
    }
    torch.cuda.synchronize()
    functional_s = time.perf_counter() - t0
    mc_metric = MulticlassAUROC(num_classes=num_classes, thresholds=num_thr, validate_args=False)
    mc_metric.update(dev["mp"], dev["mt"])
    ml_metric = MultilabelAUROC(num_labels=num_classes, thresholds=num_thr, validate_args=False)
    ml_metric.update(dev["mp"], dev["lt"])
    mc = MetricCollection([BinaryAUROC(thresholds=num_thr), BinaryAveragePrecision(thresholds=num_thr)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(total // batch):
        batch_vals = mc(dev["bp"][i * batch:(i + 1) * batch], dev["bt"][i * batch:(i + 1) * batch])
    result = mc.compute()
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    launches = k3.BINNED_CONFMAT.launches
    if launches < 4 + 2 + total // batch:
        raise AssertionError(f"path C: K3 launched {launches} times over 4 functional calls, 2 updates and 100 forwards")
    if k3.CURVE_COUNTS.launches:
        raise AssertionError(f"path C reached K3's direct body {k3.CURVE_COUNTS.launches} times; the binned entry serves it")

    for name, want in (("binary_auroc", b_auroc), ("binary_average_precision", b_ap),
                       ("multiclass_auroc", mc_auroc), ("multilabel_auroc", ml_auroc)):
        check_value(f"path C {name}", values[name], want)
    for c in range(num_classes):
        for label, metric, (tp, fp), n_pos in (("multiclass", mc_metric, per_class[c], mc_pos[c]),
                                               ("multilabel", ml_metric, per_label[c], ml_pos[c])):
            check_confmat(f"path C {label} class {c}", metric.metric_state["confmat"][:, c], tp, fp, n_pos, total // 5 - n_pos)
    check_value("path C MulticlassAUROC module", mc_metric.compute(), mc_auroc)
    check_value("path C MultilabelAUROC module", ml_metric.compute(), ml_auroc)
    if list(mc.compute_groups.values()) != [["BinaryAUROC", "BinaryAveragePrecision"]]:
        raise AssertionError(f"path C: expected one compute group of both metrics, got {mc.compute_groups}")
    for member in mc.values():
        check_confmat(f"path C {type(member).__name__}", member.metric_state["confmat"], b_tp, b_fp, b_pos, total - b_pos)
    check_value("path C BinaryAUROC", result["BinaryAUROC"], b_auroc)
    check_value("path C BinaryAveragePrecision", result["BinaryAveragePrecision"], b_ap)
    last_tp, last_fp = threshold_counts_np(b_preds[-batch:], b_target[-batch:], thr)
    last_pos = float(b_target[-batch:].sum())
    last_auroc, last_ap = binned_values_np(last_tp, last_fp, last_pos, batch - last_pos)
    check_value("path C last batch BinaryAUROC", batch_vals["BinaryAUROC"], last_auroc)
    check_value("path C last batch BinaryAveragePrecision", batch_vals["BinaryAveragePrecision"], last_ap)
    summary = {
        "functional_s": functional_s, "forward_per_s": (total // batch) / forward_s, "samples_per_s": total / forward_s,
        "values": {k: float(v) for k, v in values.items()},
    }
    return summary, launches


def run_path_d(device, k2):
    """Path D, the curve sketch at bench.py's shapes: one launch of K2's ``sketch_update`` per update,
    and none of ``hist_pair``. Returns (summary, K2 launches)."""
    from torchmetrics_tpu_torch.classification import BinaryAUROC, MulticlassAUROC
    from torchmetrics_tpu_torch.sketch import auroc_error_bound

    bins, batch, n_batches = 2048, 65_536, 16
    rng = np.random.RandomState(17)  # bench.py:741-743
    preds_np = rng.uniform(0.0, 1.0, (n_batches, batch)).astype(np.float32)
    target_np = (rng.uniform(0, 1, (n_batches, batch)) < np.clip(preds_np * 0.8 + 0.1, 0, 1)).astype(np.int32)
    num_classes, mc_rows, mc_batch = 5, 200_000, 10_000
    mc_preds = rng.rand(mc_rows, num_classes).astype(np.float32)
    mc_target = rng.randint(0, num_classes, mc_rows).astype(np.int32)
    preds = [torch.from_numpy(preds_np[i]).to(device) for i in range(n_batches)]
    target = [torch.from_numpy(target_np[i]).to(device) for i in range(n_batches)]
    mp, mt = torch.from_numpy(mc_preds).to(device), torch.from_numpy(mc_target).to(device)

    sketch = BinaryAUROC(approx="sketch", sketch_bins=bins)
    mc_sketch = MulticlassAUROC(num_classes=num_classes, approx="sketch", sketch_bins=bins)
    torch.cuda.synchronize()
    k2.SKETCH_UPDATE.launches = 0
    k2.HIST_PAIR.launches = 0
    t0 = time.perf_counter()
    for p, t in zip(preds, target):
        sketch.update(p, t)
    auc_sketch = float(sketch.compute())
    binary_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(0, mc_rows, mc_batch):
        mc_sketch.update(mp[i:i + mc_batch], mt[i:i + mc_batch])
    auc_mc = float(mc_sketch.compute())
    multiclass_s = time.perf_counter() - t0
    launches = k2.SKETCH_UPDATE.launches
    if launches != n_batches + mc_rows // mc_batch or k2.HIST_PAIR.launches:
        raise AssertionError(f"path D: {launches} sketch_update and {k2.HIST_PAIR.launches} hist_pair launches over"
                             f" {n_batches + mc_rows // mc_batch} updates; expected one sketch_update each")

    exact = BinaryAUROC()
    for p, t in zip(preds, target):
        exact.update(p, t)
    auc_exact = float(exact.compute())
    bound = auroc_error_bound(bins)
    if abs(auc_sketch - auc_exact) > bound:
        raise AssertionError(f"path D: sketch AUROC {auc_sketch} is {abs(auc_sketch - auc_exact)} from exact mode's"
                             f" {auc_exact}, beyond the bound {bound}")

    def check_hists(name, state, buckets, positive):
        for key, keep in (("pos_hist", positive), ("neg_hist", ~positive)):
            want = np.bincount(buckets[keep], minlength=bins)
            if not np.array_equal(state[key].double().cpu().numpy(), want):
                raise AssertionError(f"path D {name}: {key} differs from np.bincount of floor(s * {bins - 1})")
        pos_hist, neg_hist = (np.bincount(buckets[k], minlength=bins).astype(np.float64) for k in (positive, ~positive))
        tp, fp = np.cumsum(pos_hist[::-1])[::-1], np.cumsum(neg_hist[::-1])[::-1]
        return binned_values_np(tp, fp, tp[0], fp[0])[0]

    buckets = np.clip(np.floor(preds_np.reshape(-1) * np.float32(bins - 1)), 0, bins - 1).astype(np.int64)
    auc_hist = check_hists("BinaryAUROC", sketch.metric_state, buckets, target_np.reshape(-1) == 1)
    check_value("path D BinaryAUROC sketch", auc_sketch, auc_hist)
    mc_buckets = np.clip(np.floor(mc_preds * np.float32(bins - 1)), 0, bins - 1).astype(np.int64)
    per_class = []
    for c in range(num_classes):
        state = {k: v[c] for k, v in mc_sketch.metric_state.items()}
        per_class.append(check_hists(f"MulticlassAUROC class {c}", state, mc_buckets[:, c], mc_target == c))
    check_value("path D MulticlassAUROC sketch", auc_mc, float(np.mean(per_class)))
    summary = {
        "binary_samples_per_s": n_batches * batch / binary_s, "multiclass_samples_per_s": mc_rows / multiclass_s,
        "auroc_sketch": auc_sketch, "auroc_exact": auc_exact, "abs_error": abs(auc_sketch - auc_exact),
        "error_bound": bound, "multiclass_auroc_sketch": auc_mc,
    }
    return summary, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 1
    from torchmetrics_tpu_torch.ops import _build
    from torchmetrics_tpu_torch.ops import bincount as k1
    from torchmetrics_tpu_torch.ops import curve_counts as k3
    from torchmetrics_tpu_torch.ops import hist_pair as k2

    device = torch.device("cuda", 0)
    card = card_line()
    device_kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    sources = ["bincount", "curve_counts", "hist_pair"]
    seconds = _build.build(sources)
    print(f"build: csrc/{{{','.join(sources)}}}.cu in {seconds:.2f} s, one nvcc each, in parallel")
    for name in sources:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"K1 shared-memory branch holds up to {k1.shared_bins_max(device)} bins;"
          f" K2's up to {k2.shared_bins_max(device)} bins of each stream")

    max_err = 0
    for dtype in (torch.int32, torch.int64):
        cases, err = kernel_checks(k1, device, dtype)
        max_err = max(max_err, err)
        print(f"K1 vs plain version on the card, {dtype} counts: equal in all {cases} cases (max abs err {err})")
    print(f"K1, K3 and K2 scratch: {scratch_checks(k1, k3, k2, device)} checks exact (two calls in a row, two"
          " streams, three CUDA-graph replays of one K1, K3, hist_pair and sketch_update call)")

    # ---- path A: the benchmark headline
    num_a, batch_a = 5, 10_000
    rng = np.random.RandomState(0)
    preds_a = rng.randint(0, num_a, 1_000_000).astype(np.int32)
    target_a = rng.randint(0, num_a, 1_000_000).astype(np.int32)
    pa, ta = torch.from_numpy(preds_a).to(device), torch.from_numpy(target_a).to(device)
    mc_a = collection(num_a, validate_args=False)
    vals_a, sec_a, launches_a = run_path("path A", mc_a, k1, pa, ta, batch_a)
    res_a = check_path("path A", mc_a, preds_a, target_a, num_a,
                       (vals_a, preds_a[-batch_a:], target_a[-batch_a:]))
    print(f"path A [{card}]: C={num_a}, 100 x {batch_a} int32 labels: {100 / sec_a:.1f} forward/s,"
          f" {1_000_000 / sec_a:.4g} samples/s, K1 launches {launches_a}, branch {k1.branch(num_a**2, device)},"
          f" values {res_a}")

    # ---- path B: ImageNet-validation-shaped logits
    num_b, batch_b, n_b = 1000, 1000, 50_000
    rng = np.random.RandomState(0)
    logits_b = rng.standard_normal((n_b, num_b)).astype(np.float32)
    target_b = rng.randint(0, num_b, n_b).astype(np.int64)
    target_b[rng.rand(n_b) < 0.01] = -1
    lb, tb = torch.from_numpy(logits_b).to(device), torch.from_numpy(target_b).to(device)
    mc_b = collection(num_b, ignore_index=-1)
    vals_b, sec_b, launches_b = run_path("path B", mc_b, k1, lb, tb, batch_b)
    preds_b = logits_b.argmax(axis=1)
    res_b = check_path("path B", mc_b, preds_b, target_b, num_b,
                       (vals_b, preds_b[-batch_b:], target_b[-batch_b:]), ignore_index=-1)
    if k1.branch(num_b**2, device) != "global":
        raise AssertionError("path B's 1M-bin count was expected on the global-memory branch")
    print(f"path B [{card}]: C={num_b}, 50 x {batch_b} f32 logit rows, ignore_index=-1 on 1%:"
          f" {50 / sec_b:.1f} forward/s, {n_b / sec_b:.4g} samples/s, K1 launches {launches_b},"
          f" branch {k1.branch(num_b**2, device)}, values {res_b}")

    # ---- K1 timings at the main path's shapes, in turns (kernel, plain, library, then the kernel again)
    def timing(label, kernel, plain, library, n_bytes, n_ops, iters, tag="K1", library_name="torch.bincount",
               old=None, old_ops=None, kernels=("hist_shared", "hist_global"), old_name="direct body"):
        """Times the wrapper, its plain version, the library call and ``old`` (the path the entry
        replaced), in turns, and the kernel alone; ``before_ms`` in the result is ``old``'s time."""
        ms, plain_ms = time_ms(kernel, iters), time_ms(plain, iters)
        lib_ms = None if library is None else time_ms(library, iters)
        old_ms = None if old is None else time_ms(old, iters)
        ms = min(ms, time_ms(kernel, iters))
        b_ms, b_by = bound(n_bytes, n_ops)
        lib_text = "no single call" if lib_ms is None else f"{lib_ms:.5f} ms (ratio {ms / lib_ms:.4f})"
        old_text = ""
        if old is not None:
            old_bound = "" if old_ops is None else f", its operations bound {bound(0, old_ops)[0]:.5f} ms"
            old_text = (f", {old_name} {old_ms:.5f} ms ({device_profile(old, (), min(iters, 200))[1]:.1f} device"
                        f" operations per call{old_bound})")
        kernel_ms, ops = device_profile(kernel, kernels, min(iters, 200))
        kernel_ms /= 1e3
        print(f"timing [{card}] {label}: {tag} wrapper {ms:.5f} ms, bound {b_ms:.5f} ms ({b_by}, roofline share"
              f" {b_ms / ms:.4f}), plain {plain_ms:.5f} ms, {library_name} {lib_text}{old_text}; the kernel alone"
              f" {kernel_ms:.5f} ms on the device (share of the bound {b_ms / kernel_ms:.4f}), {ops:.1f} device"
              " operations per call")
        out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        return out if old is None else {**out, "before_ms": old_ms}

    pa_b, ta_b = pa[:batch_a], ta[:batch_a]
    fused_a = ta_b.long() * num_a + pa_b.long()
    i64 = torch.int64
    t_a = timing(
        f"path A shape (confusion, N={batch_a}, int32 labels, {num_a**2} int64 bins)",
        lambda: k1.confusion_counts(pa_b, ta_b, num_a, dtype=i64),
        lambda: k1.confusion_counts_plain(pa_b, ta_b, num_a, dtype=i64),
        lambda: torch.bincount(fused_a, minlength=num_a**2), batch_a * 8 + num_a**2 * 8, batch_a, 2000,
    )
    pb_b = torch.argmax(lb[:batch_b], dim=1)
    tb_b = tb[:batch_b]
    keep_b = (tb_b >= 0)
    fused_b = (tb_b * num_b + pb_b)[keep_b]
    timing(
        f"path B shape (confusion, N={batch_b}, int64 labels, {num_b**2} int64 bins, ignore_index)",
        lambda: k1.confusion_counts(pb_b, tb_b, num_b, ignore_index=-1, dtype=i64),
        lambda: k1.confusion_counts_plain(pb_b, tb_b, num_b, ignore_index=-1, dtype=i64),
        lambda: torch.bincount(fused_b, minlength=num_b**2), batch_b * 16 + num_b**2 * 8, batch_b, 500,
    )
    big = torch.from_numpy(np.random.RandomState(2).randint(0, 25, 2**26).astype(np.int32)).to(device)
    timing(
        "index stream N=2^26 int32, 25 int32 bins",
        lambda: k1.bincount(big, 25), lambda: k1.bincount_plain(big, 25),
        lambda: torch.bincount(big, minlength=25), 2**26 * 4 + 25 * 4, 2**26, 20,
    )
    lib1 = k1._library()
    out_a = torch.empty((num_a, num_a), dtype=i64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    scratch_a = k1.zeroed_scratch(device, stream, num_a**2 + 32)
    raw_args = (pa_b.data_ptr(), 0, ta_b.data_ptr(), 0, None, 0, 0, batch_a, num_a, out_a.data_ptr(), 1,
                scratch_a.data_ptr(), 0, stream)
    wrapper_split(card, "K1 path A shape", lambda: k1.confusion_counts(pa_b, ta_b, num_a, dtype=i64),
                  lambda: torch.empty((num_a, num_a), dtype=i64, device=device),
                  lambda: lib1.tm_confusion(*raw_args), ("hist_shared", "hist_global"))

    # ---- K3 and K2 against their plain versions, then paths C and D
    cases, errors = curve_kernel_checks(k3, k2, device)
    print(f"K3 direct body vs plain version on the card: {cases['K3']} comparisons, max abs err {errors['K3']}"
          " (0/1 weights exact, bitwise repeatable); "
          f"K2: {cases['K2']} comparisons, max abs err {errors['K2']} (0/1 weights exact)")
    print(f"K3 binned entry on the card: bitwise equal to the direct body and to its plain version in all"
          f" {binned_checks(k3, device)} cases (max abs err 0)")
    print(f"K2 sketch_update on the card: equal to its plain version (the unfused chain) in all"
          f" {sketch_checks(k2, device)} cases (max abs err 0)")
    res_c, launches_c = run_path_c(device, k3)
    print(f"path C [{card}]: binary AUROC/AP at 200 thresholds over 1,000,000 scores, multiclass and multilabel"
          f" AUROC at C=5 over 200,000 rows: functional {res_c['functional_s']:.4f} s for the four calls;"
          f" collection of BinaryAUROC + BinaryAveragePrecision, 100 x 10,000: {res_c['forward_per_s']:.1f} forward/s,"
          f" {res_c['samples_per_s']:.4g} samples/s; K3 launches {launches_c}; values {res_c['values']}")
    res_d, launches_d = run_path_d(device, k2)
    print(f"path D [{card}]: BinaryAUROC sketch (2048 bins) over 16 x 65,536: {res_d['binary_samples_per_s']:.4g}"
          f" samples/s, AUROC {res_d['auroc_sketch']:.7f} vs exact {res_d['auroc_exact']:.7f} (|diff|"
          f" {res_d['abs_error']:.3g}, bound {res_d['error_bound']:.3g}); MulticlassAUROC sketch C=5 over 200,000"
          f" rows in 20 updates: {res_d['multiclass_samples_per_s']:.4g} samples/s, AUROC"
          f" {res_d['multiclass_auroc_sketch']:.7f}; K2 launches {launches_d}, branches"
          f" {k2.branch(2048, device)} / {k2.branch(5 * 2048, device)}")

    # ---- K3 and K2 timings at the paths' shapes
    rng = np.random.RandomState(5)
    num_thr = 200
    thr200 = torch.from_numpy(np.linspace(0.0, 1.0, num_thr, dtype=np.float32)).to(device)
    search = int(np.ceil(np.log2(num_thr + 1))) + 1  # compares of the binary search and one add per element
    t_k3 = {}
    for label, kind, num_classes, n, iters in (("forward", "binary", 1, 10_000, 2000),
                                               ("one-shot", "binary", 1, 1_000_000, 50),
                                               ("multiclass", "multiclass", 5, 200_000, 50)):
        scores_nc = torch.from_numpy(rng.rand(n, num_classes).astype(np.float32)).to(device)
        if kind == "binary":
            scores, target = scores_nc[:, 0].contiguous(), torch.from_numpy(rng.randint(0, 2, n).astype(np.int32)).to(device)
            pos = target[None, :].float()
        else:
            scores, target = scores_nc, torch.from_numpy(rng.randint(0, num_classes, n).astype(np.int32)).to(device)
            pos = (target[None, :] == torch.arange(num_classes, device=device)[:, None]).float()
        rows, neg = scores_nc.T.contiguous(), 1.0 - pos
        n_bytes = num_classes * n * 4 + n * 4 + num_thr * 4 + num_thr * num_classes * 16
        n_ops = num_classes * n * search + 4 * num_classes * (num_thr + 1)
        t_k3[label] = timing(
            f"path C {label} shape ({kind}, C={num_classes}, N={n}, T={num_thr})",
            lambda: k3.binned_confmat(scores, target, thr200, kind, num_classes),
            lambda: k3.binned_confmat_plain(scores, target, thr200, kind, num_classes),
            None, n_bytes, n_ops, iters, tag="K3 binned", library_name="library:",
            old=lambda: k3.curve_counts(rows, pos, neg, thr200), old_ops=3 * num_classes * n * num_thr,
            kernels=("binned_confmat",),
        )
        if label == "forward":
            lib3 = k3._library()
            plan = k3.binned_plan(n, 1, num_thr, torch.cuda.get_device_properties(device).multi_processor_count)
            out3 = torch.empty((num_thr, 2, 2), dtype=torch.float32, device=device)
            scratch3 = k1.zeroed_scratch(device, stream, plan.head + 2 * (num_thr + 1))
            raw3 = (scores.data_ptr(), target.data_ptr(), 0, 0, n, 1, num_thr, thr200.data_ptr(), plan.group, plan.groups,
                    plan.blocks, plan.shared_bytes, plan.head, 0, 0, scratch3.data_ptr(), out3.data_ptr(), 0, stream)
            wrapper_split(card, "K3 binned, path C forward shape", lambda: k3.binned_confmat(scores, target, thr200, kind),
                          lambda: torch.empty((num_thr, 2, 2), dtype=torch.float32, device=device),
                          lambda: lib3.tm_binned_confmat(*raw3), ("binned_confmat",))
    t_k2 = {}
    for label, n, length, iters in (("path D binary shape", 65_536, 2048, 2000),
                                    ("path D multiclass shape", 50_000, 10_240, 2000),
                                    ("index stream N=2^26", 2**26, 2048, 20)):
        gen = torch.Generator(device).manual_seed(n + length)
        idx = torch.randint(0, length, (n,), device=device, dtype=torch.int32, generator=gen)
        pos = (torch.rand(n, device=device, generator=gen) < 0.5).float()
        neg = 1.0 - pos
        idx64 = idx.long()
        t_k2[label] = timing(
            f"{label} (hist_pair, N={n} int32, {length} bins, branch {k2.branch(length, device)})",
            lambda: k2.hist_pair(idx, pos, neg, length), lambda: k2.hist_pair_plain(idx, pos, neg, length),
            lambda: (torch.bincount(idx64, weights=pos, minlength=length), torch.bincount(idx64, weights=neg, minlength=length)),
            n * 12 + 2 * length * 4, int((pos != 0).sum().item() + (neg != 0).sum().item()), iters,
            tag="K2", library_name="two weighted torch.bincount", kernels=("pair_shared", "pair_global"),
        )
        if label == "path D binary shape":
            lib2 = k2._library()
            out2 = torch.empty((2, length), dtype=torch.float32, device=device)
            scratch2 = k1.zeroed_scratch(device, stream, k2.SCRATCH_HEAD + 2 * length)
            raw2 = (idx.data_ptr(), 0, pos.data_ptr(), neg.data_ptr(), n, length, scratch2.data_ptr(), out2.data_ptr(), 0,
                    stream)
            wrapper_split(card, "K2 hist_pair, path D binary shape", lambda: k2.hist_pair(idx, pos, neg, length),
                          lambda: torch.empty((2, length), dtype=torch.float32, device=device),
                          lambda: lib2.tm_hist_pair(*raw2), ("pair_shared", "pair_global"))

    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _exact_state, _one_vs_rest
    from torchmetrics_tpu_torch.sketch.hist import hist_update_classes, hist_update_pair

    t_sketch = {}
    bins = 2048
    for label, kind, n, classes, iters in (("path D binary shape", "binary", 65_536, 1, 2000),
                                           ("path D multiclass shape", "multiclass", 10_000, 5, 2000),
                                           ("binary N=2^26", "binary", 2**26, 1, 20)):
        gen = torch.Generator(device).manual_seed(n + classes)
        scores = torch.rand((n,) if kind == "binary" else (n, classes), device=device, generator=gen)
        if kind == "binary":
            target = (torch.rand(n, device=device, generator=gen) < scores).int()
        else:
            target = torch.randint(0, classes, (n,), device=device, dtype=torch.int32, generator=gen)
        zeros = torch.zeros((bins,) if kind == "binary" else (classes, bins), device=device)
        old = (zeros, zeros)  # the old (pos, neg) state

        def chain(scores=scores, target=target, old=old, kind=kind, classes=classes):
            """The sketch branch of PR 3's curve classes: ``_exact_state``, the weights, ``hist_update_*``."""
            preds, t, weight = _exact_state(scores, target, None)
            if kind == "binary":
                tf = t.to(torch.float32)
                return hist_update_pair(*old, preds, weight * tf, weight * (1.0 - tf))
            one = _one_vs_rest(t, classes)
            w = weight[:, None]
            return hist_update_classes(*old, preds, one * w, (1.0 - one) * w)

        t_sketch[label] = timing(
            f"{label} (sketch_update {kind}, N={n}, C={classes}, {bins} bins, int32 target)",
            lambda: k2.sketch_update(scores, target, *old, kind), lambda: k2.sketch_update_plain(scores, target, *old, kind),
            None, scores.numel() * 4 + n * 4 + 4 * old[0].numel() * 4, scores.numel(), iters, tag="K2 sketch_update",
            library_name="library:", old=chain, old_name="unfused chain it replaced (elementwise steps + hist_pair)",
            kernels=("sketch_update",),
        )
        if label == "path D binary shape":
            out_s = torch.empty((2, bins), dtype=torch.float32, device=device)
            scratch_s = k1.zeroed_scratch(device, stream, 2 * k2.SCRATCH_HEAD + 2 * bins)
            head = k2._sketch_layout("binary", scores.shape, target.shape, old[0].shape)[2]
            raw_s = (scores.data_ptr(), target.data_ptr(), 0, 0, n, 1, bins, 0, 0, old[0].data_ptr(), old[1].data_ptr(),
                     scratch_s.data_ptr(), head, out_s.data_ptr(), 0, stream)
            wrapper_split(card, "K2 sketch_update, path D binary shape",
                          lambda: k2.sketch_update(scores, target, *old, "binary"),
                          lambda: torch.empty((2, bins), dtype=torch.float32, device=device),
                          lambda: k2._library().tm_sketch_update(*raw_s), ("sketch_update",))

    kernels = [{
        "name": "bincount", "route": "cuda", "source": "torchmetrics_tpu_torch/csrc/bincount.cu",
        "replaces": "torchmetrics_tpu/ops/pallas_hist.py:28", "launches": launches_a + launches_b,
        "max_abs_err": max_err, **t_a,
    }, {
        "name": "curve_counts", "entry": "binned_confmat", "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/curve_counts.cu", "replaces": "torchmetrics_tpu/ops/pallas_curve.py:44",
        "launches": launches_c, "max_abs_err": 0.0, **t_k3["forward"],
    }, {
        "name": "hist_pair", "entry": "sketch_update", "route": "cuda", "source": "torchmetrics_tpu_torch/csrc/hist_pair.cu",
        "replaces": "torchmetrics_tpu/ops/pallas_hist.py:92", "launches": launches_d,
        "max_abs_err": errors["K2"], **t_sketch["path D binary shape"], "hist_pair": t_k2["path D binary shape"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
