#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card, check them, and time their kernels.

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
   shapes and at N = 2^26, beside their bounds, plain versions and library calls;
9. path E, BASELINE config #2 (``bench.py:2074-2105``, seed 3): ``multiclass_stat_scores``,
   ``multiclass_confusion_matrix`` and ``multiclass_f1_score`` (macro) over 1,000,000 int32 labels
   at C = 5 and ``binary_f1_score`` over 1,000,000 float32 scores; the collection
   ``[BinaryAccuracy, BinaryPrecision, BinaryRecall, BinaryF1Score]`` through 100 ``forward``
   calls of 10,000, one K1 launch per step after the first; ``MultilabelF1Score`` and
   ``MultilabelConfusionMatrix`` at L = 5 over 200,000 rows; and ``MulticlassConfusionMatrix`` at
   C = 1000 on path B's logits, on K1's global branch;
10. path F: ``[BinaryRecallAtFixedPrecision, BinaryPrecisionAtFixedRecall,
    BinarySpecificityAtSensitivity, BinaryAUROC]`` at ``thresholds=200`` and floor 0.5 over path
    C's 1,000,000 scores in 100 ``forward`` calls, one compute group and one K3 launch per step;
    the three multiclass forms at C = 5 over 200,000 rows, binned (K3) and ``approx="sketch"``
    (one K2 ``sketch_update`` per update); ``MulticlassCalibrationError`` (C = 1000, 15 bins) on
    path B's logits with ``ignore_index=-1``, and ``BinaryCalibrationError`` on path C's scores;
    then K1 timed at its worst contention, 4 bins over 1,000,000 binary labels;
11. path G, the benchmark's headline protocol (``bench.py:42-106``, data ``bench.py:35-39``, seed 7):
    the four-metric collection with ``validate_args=False`` over 100 x 10,000 int32 labels, through
    ``sweep_fn`` and through ``update_batches`` + ``compute`` five times with a reset before each
    (``host_api_rate``, updates/s); its state against path A's per-step loop over the same stack,
    ``buffered(32)`` against per-step updates, and ``MeanMetric``, ``MaxMetric`` and ``SumMetric``
    over the same stream cast to float32;
12. path H, BASELINE config #5 at full size (``bench.py:2182-2214``, seed 9): ``RetrievalMAP`` and
    ``RetrievalNormalizedDCG`` over 2^20 documents and 10,000 sorted query ids, three ``reset`` +
    ``update`` + ``compute`` per window (``3 * n / best``, best of three) and the wall of one compute;
    the flat compute is one captured graph, replayed by every later compute, and every compute
    must give the first one's bits; values within 1e-5 of an independent numpy evaluation (a sort
    per query, AP directly, NDCG with sklearn's tie-averaged DCG). Then a ragged set, 50,000
    documents over 1,000 unsorted ids with tied scores and ``ignore_index=-1``: all ten metrics,
    every empty action (``"error"`` must raise), every aggregation, ``top_k`` and ``adaptive_k``;
13. path I, on path A's data: ``MulticlassAccuracy + MulticlassF1Score`` and ``abs(acc - f1)``
    through ``forward`` and ``compute`` against numpy, one graph replay and one K1 launch per operand
    per step; ``MeanMetric`` with ``set_dtype(torch.float64)`` after five steps, whose next step
    must capture one new graph with no fallback;
14. path J, the rest of classification: J1 on path B's logits (C = 1000, 50 x 1,000 rows,
    ``ignore_index=-1``): ``[MulticlassCohenKappa(weights="quadratic"), MulticlassMatthewsCorrCoef,
    MulticlassJaccardIndex]`` (one compute group on the 1000 x 1000 confusion matrix, K1's global
    branch), ``[MulticlassSpecificity, MulticlassHammingDistance]`` (macro, one stat-scores group),
    ``MulticlassHingeLoss`` in both modes and ``Dice(num_classes=1000, average="macro")``; J2 at
    COCO's 80 labels, 100,000 rows in 10 batches (seed 21): the three ranking metrics,
    ``MultilabelExactMatch``, ``[MultilabelJaccardIndex, MultilabelMatthewsCorrCoef]`` and
    ``MultilabelHammingDistance``; J3, 1,000,000 scores in 8 groups in 100 calls of 10,000 (seed
    23): ``BinaryFairness(task="all")``, exactly one K1 launch and no K2 launch per call,
    ``BinaryGroupStatRates``, ``[BinaryCohenKappa, BinaryMatthewsCorrCoef]``,
    ``BinaryHingeLoss(squared=True)`` and ``BinarySpecificity``; J4, a ragged set of 2,000 samples
    (seed 29) through all 31 classes and 33 functional entries of the slice, every ``average``,
    ``multidim_average``, ``top_k``, ``ignore_index``, kappa weight and hinge mode, and the edges: an
    all-ignored batch, an absent class, a single group, tied fairness rates, tied ranking scores,
    Dice's ``multiclass=False``. J1-J3's counts must equal ``np.bincount``'s, their values a float64
    numpy evaluation within 1e-5 (relative above 1, absolute below, as MCC and kappa of random labels
    lie near 0), the ranking metrics sklearn's definitions; J4 must agree with the CPU's plain
    versions (which the CPU tests hold to the JAX package) within 1e-5, and the ranking metrics with
    a per-sample numpy loop;
15. path K, regression (no kernel on it; every kernel's count must stay 0 through it): K1, 13
    metrics (``[MeanSquaredError, RMSE]``, MAE, ``[R2Score, RelativeSquaredError]``,
    ``ExplainedVariance``, ``[PearsonCorrCoef, ConcordanceCorrCoef]``, MAPE, SMAPE, WMAPE,
    ``LogCoshError``, ``MinkowskiDistance(p=3)``) over 1,000,000 lognormal targets (seed 29) in 100
    ``forward`` calls of 10,000, each batch value against float64 numpy, then ``reset`` +
    ``update_batches`` + ``compute`` bit-equal to the loop's ``compute``; K2, eight outputs over
    100 x 10,000 rows (seed 31), column 5 of mean 100 and std 1, where float32 moments cancel
    (its R² and explained variance held to a derived float32 bound, printed beside the error);
    K3, ``SpearmanCorrCoef`` over 1,000,000 pairs with 10% ties against ``scipy.stats.spearmanr``
    and ``KendallRankCorrCoef`` (tau-b and tau-c, ``t_test``) over 50,000 tied pairs against
    ``scipy.stats.kendalltau``, with the compute's wall and peak device memory; K4,
    ``CosineSimilarity`` over 100 x 1,000 768-d embedding pairs, ``KLDivergence`` on
    probabilities and on log-probabilities over 100 x 1,000 rows of 1,000 classes,
    ``TweedieDevianceScore(power=1.5)`` and ``MeanSquaredLogError`` over 1,000,000 claims (seed
    43); K5, a ragged set of 2,000 samples (seed 47) through all 18 classes and 18 functions with
    NaN and +-inf in Kendall, ties, zeros in KL's ``q`` (inf), one sample, ``adjusted`` at and beyond
    ``n - 1`` and every Tweedie branch, against the port's CPU run within 1e-5;
16. path L, distributed state sync (``parallel/sync.py``) and the wrappers: L1, a one-rank NCCL world
    in this process (a TCP store on a free local port), path A's collection and path H's MAP built
    with ``distributed_available_fn`` so that their computes sync: bit-equal to the same computes with
    no process group, and the profiler must show NCCL's all-gathers on the card (it prints their
    count and device time); L2, two ranks of one gloo world on this card (this script run twice with
    ``--sync-worker``; gloo through host memory, since NCCL refuses two ranks on one card), each with its
    share of path A's labels, path B's logits (the collection and the 1000 x 1000 confusion matrix),
    path C's binned AUROC + AP, path D's sketched AUROC, path H's documents split 600,000 and 448,576,
    K1's pairs split 370,000 and 630,000 (Pearson, MSE), K4's cosine ``cat`` states (100 x 1,000 x 768)
    and a ``CatMetric`` whose rank 1 is idle: both ranks must hold the same bits, and rank 0's value
    the single-process compute's over the whole data (counts and ``cat`` states exactly, float sums
    within 1e-6 relative, Pearson within 1e-5), each printed with its sync wall per compute, gathers and
    bytes; L3, the six wrappers at full width on both tiers: ``BootStrapper`` of ``MulticlassAccuracy``
    (10 copies, seed 0) over path A against the port's CPU run under the same seed,
    ``ClasswiseWrapper`` of ``MulticlassF1Score(1000, average=None)`` over path B, ``MultioutputWrapper``
    of ``R2Score`` over K2's eight outputs, ``MetricTracker`` over five epochs of path A's collection,
    ``MultitaskWrapper`` of path A's collection and K1's MSE, ``MinMaxMetric`` of ``BinaryAccuracy``
    over path C's scores, each against float64 numpy. Path L's kernel launches join the kernels line.

Paths A and C-K run on the graph tier (``ops/dispatch.py``: each fused step one captured CUDA
graph per input signature, the update-only steps through ``fast_update``) and then on the eager
tier (``TM_TPU_FAST_DISPATCH=0``), and the two must give the same counts and values bit for bit.
On the graph tier each loop must show, step by step, no eager fallback, one graph replay per
compute group once captured, and as many kernel launches as its replays hold plus its captures'
warm-ups (``StepLog``); path G holds 100 K1 launches per sweep. Each path prints, per tier, the
host's wall per step (the steps without a capture), the device operations per step, the graph
replays and the fallbacks.

Counts must equal numpy's (``np.bincount``, or a compare-and-sum over the thresholds) exactly;
stat-score values the numpy formulas within 1e-6, curve values (fixed-point values and their
thresholds, calibration errors) a float64 numpy evaluation of the same formulas within 1e-5, and
the sketch's AUROC exact mode's within ``auroc_error_bound(2048)``; path K's values float64
numpy's or scipy's within 1e-5 relative, or within the float32 bound that ``check_rel``
prints where it is larger (``PERF.md`` §2). Every check raises, so a failed phase ends the run with a non-zero
exit. The last line is ``{"ok": true, "device": {...}}``; the line before it lists the kernels.
Without a CUDA device, or without the package beside it, the script exits non-zero.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings
from contextlib import contextmanager

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


@contextmanager
def tier(name: str):
    """Run a block on one dispatch tier: ``graph`` (the default: captured CUDA graphs) or ``eager``
    (``TM_TPU_FAST_DISPATCH=0``)."""
    from torchmetrics_tpu_torch.ops import dispatch

    old = os.environ.pop(dispatch.ENV_FAST_DISPATCH, None)
    if name == "eager":
        os.environ[dispatch.ENV_FAST_DISPATCH] = "0"
    try:
        yield
    finally:
        os.environ.pop(dispatch.ENV_FAST_DISPATCH, None)
        if old is not None:
            os.environ[dispatch.ENV_FAST_DISPATCH] = old


class StepLog:
    """Per-step counts of one loop on one tier: a kernel's launches, graph replays and captures, and
    eager fallbacks (``ops.dispatch.STATS``), and the loop's wall time."""

    def __init__(self, name: str, tier_name: str, counter=None) -> None:
        self.name, self.tier, self.counter = name, tier_name, counter
        self.steps = []
        self.seconds = []

    def _now(self):
        from torchmetrics_tpu_torch.ops.dispatch import STATS

        return (0 if self.counter is None else self.counter.launches, STATS.replays, STATS.captures, STATS.n_fallbacks)

    def __call__(self, fn, *args):
        before = self._now()
        t0 = time.perf_counter()
        out = fn(*args)
        self.seconds.append(time.perf_counter() - t0)
        self.steps.append(tuple(a - b for a, b in zip(self._now(), before)))
        return out

    def check(self, eager_first: int, groups: int = 1, per_graph: int = 1) -> None:
        """Graph tier: no step fell back; a step launched what its replays and its captures' warm-ups
        hold (``per_graph`` each); a step without a capture replayed one graph per group. Eager tier:
        no graph, and ``eager_first`` launches on the first step, ``per_graph`` on each later one."""
        for i, (launches, replays, captures, fallbacks) in enumerate(self.steps):
            where = f"{self.name} ({self.tier} tier) step {i}: {launches} launches, {replays} replays, {captures} captures," \
                    f" {fallbacks} fallbacks"
            if self.tier == "graph":
                steady = captures == 0 and replays == groups
                if fallbacks or (self.counter is not None and launches != (replays + captures) * per_graph) or \
                        (captures == 0 and not steady):
                    raise AssertionError(where)
            else:
                want = eager_first if i == 0 else per_graph
                if replays or captures or (self.counter is not None and launches != want):
                    raise AssertionError(where + f"; expected {want} launches and no graph")

    def line(self) -> str:
        """The host's wall per step over the steps without a capture (the card is not synchronised
        inside the loop), median and mean, and the capturing steps' wall apart."""
        steady = [(s, t) for s, t in zip(self.steps, self.seconds) if s[2] == 0]
        capturing = [t for s, t in zip(self.steps, self.seconds) if s[2]]
        walls = [t for _, t in steady] or [0.0]
        replays = sum(s[1] for s, _ in steady) / max(len(steady), 1)
        return (f"{self.tier} tier: wall {np.median(walls) * 1e3:.4f} ms/step median, {np.mean(walls) * 1e3:.4f} mean,"
                f" over the {len(steady)} steps without a capture ({len(capturing)} capturing steps:"
                f" {sum(capturing) * 1e3:.1f} ms), {replays:.2f} graph replays/step, {sum(s[2] for s in self.steps)}"
                f" captures, {sum(s[3] for s in self.steps)} fallbacks")


def device_ops_per_step(step, batches) -> float:
    """Device operations per call of ``step`` over ``batches``, from ``torch.profiler`` (after one
    untraced call, so that any capture happens outside the window)."""
    step(*batches[0])
    calls = iter(batches)
    return device_profile(lambda: step(*next(calls)), (), len(batches))[1]


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


def run_path(name, mc, k1, preds_dev, target_dev, batch: int, tier_name: str = "graph"):
    """Drive ``forward`` over the batches with K1's count set to 0 just before; returns
    (last batch values, seconds, launches, the loop's ``StepLog``)."""
    n_batches = target_dev.shape[0] // batch
    log = StepLog(name, tier_name, k1.BINCOUNT)
    torch.cuda.synchronize()
    k1.BINCOUNT.launches = 0
    t0 = time.perf_counter()
    for i in range(n_batches):
        vals = log(mc, preds_dev[i * batch:(i + 1) * batch], target_dev[i * batch:(i + 1) * batch])
    mc.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = k1.BINCOUNT.launches
    if launches < n_batches:
        raise AssertionError(f"{name}: K1 launched {launches} times over {n_batches} forward calls")
    return vals, seconds, launches, log


def same_on_both_tiers(name: str, graph, eager) -> None:
    """The graph tier's counts and values equal the eager tier's, bit for bit."""
    if graph != eager:
        raise AssertionError(f"{name}: the graph tier gives {graph}, the eager tier {eager}")


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


def run_path_c(device, k3, tier_name: str = "graph"):
    """Path C, BASELINE config #3 at bench.py's shapes, on one dispatch tier. Returns (summary, K3
    launches, the collection loop's ``StepLog``)."""
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
    ml_metric = MultilabelAUROC(num_labels=num_classes, thresholds=num_thr, validate_args=False)
    updates = StepLog("path C updates", tier_name, k3.BINNED_CONFMAT)
    for metric, target in ((mc_metric, dev["mt"]), (ml_metric, dev["lt"])):
        metric.fast_update = True  # the update-only graph tier (off by default, as in the JAX package)
        updates(metric.update, dev["mp"], target)
    updates.check(eager_first=1)
    mc = MetricCollection([BinaryAUROC(thresholds=num_thr), BinaryAveragePrecision(thresholds=num_thr)])
    log = StepLog("path C", tier_name, k3.BINNED_CONFMAT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(total // batch):
        batch_vals = log(mc, dev["bp"][i * batch:(i + 1) * batch], dev["bt"][i * batch:(i + 1) * batch])
    result = mc.compute()
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    log.check(eager_first=2)
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
        "collection": {k: float(v) for k, v in result.items()}, "last_batch": {k: float(v) for k, v in batch_vals.items()},
        "modules": [float(mc_metric.compute()), float(ml_metric.compute())],
        "device_ops_per_step": device_ops_per_step(mc, [(dev["bp"][i * batch:(i + 1) * batch], dev["bt"][i * batch:(i + 1) * batch])
                                                        for i in range(10)]),
    }
    return summary, launches, log


def run_path_d(device, k2, tier_name: str = "graph"):
    """Path D, the curve sketch at bench.py's shapes, on one dispatch tier: one launch of K2's
    ``sketch_update`` per update (and per capture's warm-up on the graph tier), and none of
    ``hist_pair``. Returns (summary, K2 launches, the two update loops' ``StepLog``s)."""
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
    sketch.fast_update = mc_sketch.fast_update = True  # the update-only graph tier
    logs = (StepLog("path D binary sketch", tier_name, k2.SKETCH_UPDATE),
            StepLog("path D multiclass sketch", tier_name, k2.SKETCH_UPDATE))
    torch.cuda.synchronize()
    k2.SKETCH_UPDATE.launches = 0
    k2.HIST_PAIR.launches = 0
    t0 = time.perf_counter()
    for p, t in zip(preds, target):
        logs[0](sketch.update, p, t)
    auc_sketch = float(sketch.compute())
    binary_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(0, mc_rows, mc_batch):
        logs[1](mc_sketch.update, mp[i:i + mc_batch], mt[i:i + mc_batch])
    auc_mc = float(mc_sketch.compute())
    multiclass_s = time.perf_counter() - t0
    launches = k2.SKETCH_UPDATE.launches
    for log in logs:
        log.check(eager_first=1)
    warmups = sum(s[2] for log in logs for s in log.steps)  # each capture's warm-up launched once
    if launches != n_batches + mc_rows // mc_batch + warmups or k2.HIST_PAIR.launches:
        raise AssertionError(f"path D: {launches} sketch_update and {k2.HIST_PAIR.launches} hist_pair launches over"
                             f" {n_batches + mc_rows // mc_batch} updates and {warmups} warm-ups; expected one"
                             " sketch_update each")

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
        "device_ops_per_update": device_ops_per_step(sketch.update, list(zip(preds[:10], target[:10]))),
    }
    return summary, launches, logs


def stat_counts_np(preds01: np.ndarray, target01: np.ndarray):
    """float64 tp, fp, tn, fn of 0/1 labels, summed over the first axis."""
    p, t = preds01.astype(bool), target01.astype(bool)
    return tuple(np.sum(x, axis=0).astype(np.float64) for x in (p & t, p & ~t, ~p & ~t, ~p & t))


def div_np(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.divide(a, b, out=np.zeros_like(a), where=b != 0)


def binary_values_np(tp, fp, tn, fn):
    """float64 accuracy, precision, recall and F1 of binary counts."""
    return {"BinaryAccuracy": float(div_np(tp + tn, tp + tn + fp + fn)), "BinaryPrecision": float(div_np(tp, tp + fp)),
            "BinaryRecall": float(div_np(tp, tp + fn)), "BinaryF1Score": float(div_np(2 * tp, 2 * tp + fp + fn))}


def check_counts(name: str, got: torch.Tensor, want: np.ndarray) -> None:
    got = got.cpu().numpy()
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{name}: counts differ from numpy's")


def run_path_e(device, k1, logits_b, target_b, tier_name: str = "graph"):
    """Path E, BASELINE config #2 (``bench.py:2074-2105``, seed 3), and the binary and multilabel
    stat scores and confusion matrices at full size, on one dispatch tier. Returns (summary, K1
    launches, the binary collection's ``StepLog``)."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import (
        BinaryAccuracy,
        BinaryF1Score,
        BinaryPrecision,
        BinaryRecall,
        MulticlassConfusionMatrix,
        MultilabelConfusionMatrix,
        MultilabelF1Score,
    )
    from torchmetrics_tpu_torch.functional import (
        binary_f1_score,
        multiclass_confusion_matrix,
        multiclass_f1_score,
        multiclass_stat_scores,
    )

    num_classes, total, batch = 5, 1_000_000, 10_000
    rng = np.random.RandomState(3)  # bench.py:2084-2088, in its order
    mc_preds = rng.randint(0, num_classes, size=total).astype(np.int32)
    mc_target = rng.randint(0, num_classes, size=total).astype(np.int32)
    b_preds = rng.rand(total).astype(np.float32)
    b_target = rng.randint(0, 2, size=total).astype(np.int32)
    ml_rows, num_labels = 200_000, 5
    ml_preds = rng.rand(ml_rows, num_labels).astype(np.float32)
    ml_target = rng.randint(0, 2, size=(ml_rows, num_labels)).astype(np.int32)
    dev = {k: torch.from_numpy(v).to(device) for k, v in (("mp", mc_preds), ("mt", mc_target), ("bp", b_preds),
                                                          ("bt", b_target), ("lp", ml_preds), ("lt", ml_target))}

    # numpy's counts and the float64 values of the same formulas
    cm = np.bincount(mc_target * num_classes + mc_preds, minlength=num_classes**2).reshape(num_classes, num_classes)
    tp = np.diag(cm).astype(np.float64)
    fp, fn = cm.sum(0) - tp, cm.sum(1) - tp
    mc_scores = np.stack([tp, fp, cm.sum() - tp - fp - fn, fn, tp + fn], axis=-1).astype(np.int64)
    mc_f1 = float(div_np(2 * tp, 2 * tp + fp + fn)[(tp + fp + fn) > 0].mean())
    b01 = b_preds > np.float32(0.5)
    b_counts = stat_counts_np(b01, b_target)
    ml_counts = stat_counts_np(ml_preds > np.float32(0.5), ml_target)  # per label
    ml_f1 = float(div_np(2 * ml_counts[0], 2 * ml_counts[0] + ml_counts[1] + ml_counts[3]).mean())
    ml_cm = np.stack([np.stack([ml_counts[2], ml_counts[1]], -1), np.stack([ml_counts[3], ml_counts[0]], -1)], -2)
    target_b_np = target_b.cpu().numpy()
    keep_b = target_b_np != -1
    preds_b = logits_b.argmax(dim=1).cpu().numpy()
    cm_b = np.bincount(target_b_np[keep_b] * 1000 + preds_b[keep_b], minlength=1000**2).reshape(1000, 1000)

    torch.cuda.synchronize()
    k1.BINCOUNT.launches = 0
    t0 = time.perf_counter()
    functional = {
        "multiclass_stat_scores": multiclass_stat_scores(dev["mp"], dev["mt"], num_classes, average="macro",
                                                         validate_args=False),
        "multiclass_confusion_matrix": multiclass_confusion_matrix(dev["mp"], dev["mt"], num_classes, validate_args=False),
        "multiclass_f1": multiclass_f1_score(dev["mp"], dev["mt"], num_classes, average="macro", validate_args=False),
        "binary_f1": binary_f1_score(dev["bp"], dev["bt"], validate_args=False),
    }
    torch.cuda.synchronize()
    functional_s = time.perf_counter() - t0
    if k1.BINCOUNT.launches != 4:
        raise AssertionError(f"path E: K1 launched {k1.BINCOUNT.launches} times over 4 functional calls")
    check_counts("path E multiclass_stat_scores", functional["multiclass_stat_scores"], mc_scores)
    check_counts("path E multiclass_confusion_matrix", functional["multiclass_confusion_matrix"], cm)
    check_value("path E multiclass_f1", functional["multiclass_f1"], mc_f1, TOL)
    check_value("path E binary_f1", functional["binary_f1"], binary_values_np(*b_counts)["BinaryF1Score"], TOL)

    mc = MetricCollection([BinaryAccuracy(), BinaryPrecision(), BinaryRecall(), BinaryF1Score()])
    log = StepLog("path E", tier_name, k1.BINCOUNT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(total // batch):
        batch_vals = log(mc, dev["bp"][i * batch:(i + 1) * batch], dev["bt"][i * batch:(i + 1) * batch])
    result = mc.compute()
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    log.check(eager_first=4)  # eager: 4 launches on the first step (one per metric), then one per step
    if list(mc.compute_groups.values()) != [["BinaryAccuracy", "BinaryPrecision", "BinaryRecall", "BinaryF1Score"]]:
        raise AssertionError(f"path E: expected one compute group of the four binary metrics, got {mc.compute_groups}")
    for member in mc.values():
        for key, want in zip(("tp", "fp", "tn", "fn"), b_counts):
            check_counts(f"path E {type(member).__name__}.{key}", member.metric_state[key], np.asarray(want, np.int64))
    for key, want in binary_values_np(*b_counts).items():
        check_value(f"path E {key}", result[key], want, TOL)
    for key, want in binary_values_np(*stat_counts_np(b01[-batch:], b_target[-batch:])).items():
        check_value(f"path E last batch {key}", batch_vals[key], want, TOL)

    ml_f1_metric = MultilabelF1Score(num_labels=num_labels)
    ml_cm_metric = MultilabelConfusionMatrix(num_labels=num_labels)
    ml_f1_metric.fast_update = ml_cm_metric.fast_update = True  # the update-only graph tier
    ml_log = StepLog("path E multilabel", tier_name, k1.BINCOUNT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, ml_rows, batch):
        for metric in (ml_f1_metric, ml_cm_metric):
            ml_log(metric.update, dev["lp"][i:i + batch], dev["lt"][i:i + batch])
    ml_value, ml_confmat = ml_f1_metric.compute(), ml_cm_metric.compute()
    torch.cuda.synchronize()
    multilabel_s = time.perf_counter() - t0
    ml_log.check(eager_first=1)  # one launch per update, and one per capture's warm-up
    check_counts("path E MultilabelConfusionMatrix", ml_confmat, ml_cm.astype(np.int64))
    check_counts("path E MultilabelF1Score.tp", ml_f1_metric.metric_state["tp"], ml_counts[0].astype(np.int64))
    check_value("path E MultilabelF1Score", ml_value, ml_f1, TOL)

    wide = MulticlassConfusionMatrix(num_classes=1000, ignore_index=-1)
    wide.fast_update = True
    wide_log = StepLog("path E C=1000", tier_name, k1.BINCOUNT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, logits_b.shape[0], 1000):
        wide_log(wide.update, logits_b[i:i + 1000], target_b[i:i + 1000])
    wide_cm = wide.compute()
    torch.cuda.synchronize()
    wide_s = time.perf_counter() - t0
    wide_log.check(eager_first=1)
    if k1.branch(1000**2, device) != "global":
        raise AssertionError("path E: the C = 1000 confusion matrix must count on the global branch")
    check_counts("path E MulticlassConfusionMatrix C=1000", wide_cm, cm_b)
    summary = {
        "functional_s": functional_s, "forward_per_s": (total // batch) / forward_s, "samples_per_s": total / forward_s,
        "multilabel_rows_per_s": ml_rows / multilabel_s, "confmat_1000_rows_per_s": logits_b.shape[0] / wide_s,
        "values": {"multiclass_f1": float(functional["multiclass_f1"]), "binary_f1": float(functional["binary_f1"]),
                   **{k: float(v) for k, v in result.items()}, "MultilabelF1Score": float(ml_value)},
        "last_batch": {k: float(v) for k, v in batch_vals.items()},
        "device_ops_per_step": device_ops_per_step(mc, [(dev["bp"][i * batch:(i + 1) * batch], dev["bt"][i * batch:(i + 1) * batch])
                                                        for i in range(10)]),
    }
    return summary, k1.BINCOUNT.launches, log


def lex_select_np(maximize, tiebreak, thresholds, constraint, floor: float):
    """float64 (best, threshold) of the largest (maximize, tiebreak, threshold) triple among the rows
    that meet the floor; the threshold is 1e6 when none does or the best is 0."""
    n = min(maximize.size, tiebreak.size, thresholds.size)
    mask = constraint[:n] >= floor
    keys = [np.where(mask, x[:n], -1.0) for x in (thresholds, tiebreak, maximize)]
    idx = np.lexsort(keys)[-1]
    best = max(keys[2][idx] if mask.any() else 0.0, 0.0)
    return best, (1e6 if best == 0.0 else keys[0][idx])


def fixed_point_np(tp: np.ndarray, fp: np.ndarray, n_pos: float, n_neg: float, thr: np.ndarray, floor: float):
    """float64 recall at precision, precision at recall and specificity at sensitivity, each a
    (value, threshold) pair, of the binned formulas from per-threshold counts."""
    recall_t = div_np(tp, np.full_like(tp, n_pos))
    precision = np.r_[div_np(tp, tp + fp), 1.0]
    recall = np.r_[recall_t, 0.0]
    tpr, fpr, thr_desc = recall_t[::-1], div_np(fp, np.full_like(fp, n_neg))[::-1], thr[::-1]
    mask = tpr >= floor
    idx = int(np.argmax(np.where(mask, 1.0 - fpr, -1.0)))
    return {"recall_at_precision": lex_select_np(recall, precision, thr, precision, floor),
            "precision_at_recall": lex_select_np(precision, recall, thr, recall, floor),
            "specificity_at_sensitivity": (max(1.0 - fpr[idx], 0.0), thr_desc[idx]) if mask.any() else (0.0, 1e6)}


def check_pair(name: str, got, want) -> None:
    check_value(f"{name} value", got[0], want[0])
    check_value(f"{name} threshold", got[1], want[1])


def calibration_np(conf: np.ndarray, correct: np.ndarray, weight: np.ndarray, n_bins: int) -> float:
    """float64 expected calibration error (l1) over the float32 grid ``k * float32(1 / n_bins)``."""
    edges = np.arange(n_bins + 1, dtype=np.float32) * np.float32(1.0 / n_bins)
    edges[-1] = 1.0
    bins = np.searchsorted(edges, conf, side="right") - 1
    count = np.bincount(bins, weights=weight, minlength=n_bins + 1)
    conf_sum = np.bincount(bins, weights=conf * weight, minlength=n_bins + 1)
    acc_sum = np.bincount(bins, weights=correct * weight, minlength=n_bins + 1)
    gap = np.abs(div_np(acc_sum, count) - div_np(conf_sum, count))
    return float(np.sum(gap * count / count.sum()))


FIXED_POINT = {"RecallAtFixedPrecision": "recall_at_precision", "PrecisionAtFixedRecall": "precision_at_recall",
               "SpecificityAtSensitivity": "specificity_at_sensitivity"}


def run_path_f(device, k3, k2, logits_b, target_b, tier_name: str = "graph"):
    """Path F: the fixed-point metrics on path C's data, binned and sketched, and calibration error
    on paths B and C, on one dispatch tier. Returns (summary, K3 launches, K2 sketch_update launches,
    the fixed-point collection's ``StepLog``)."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch import classification as tc

    num_thr, num_classes, total, batch, floor, bins = 200, 5, 1_000_000, 10_000, 0.5, 2048
    rng = np.random.RandomState(5)  # path C's data: bench.py:2150-2156, in its order
    b_preds = rng.rand(total).astype(np.float32)
    b_target = rng.randint(0, 2, size=total).astype(np.int32)
    mc_preds = rng.rand(total // 5, num_classes).astype(np.float32)
    mc_target = rng.randint(0, num_classes, size=total // 5).astype(np.int32)
    bp, bt = torch.from_numpy(b_preds).to(device), torch.from_numpy(b_target).to(device)
    mp, mt = torch.from_numpy(mc_preds).to(device), torch.from_numpy(mc_target).to(device)
    thr = np.linspace(0.0, 1.0, num_thr, dtype=np.float32)

    b_tp, b_fp = threshold_counts_np(b_preds, b_target, thr)
    b_pos = float(b_target.sum())
    b_want = fixed_point_np(b_tp, b_fp, b_pos, total - b_pos, thr.astype(np.float64), floor)
    b_auroc = binned_values_np(b_tp, b_fp, b_pos, total - b_pos)[0]
    sketch_thr = np.linspace(0.0, 1.0, bins, dtype=np.float32).astype(np.float64)
    buckets = np.clip(np.floor(mc_preds * np.float32(bins - 1)), 0, bins - 1).astype(np.int64)
    wants = {"binned": [], "sketch": []}
    for c in range(num_classes):
        positive = mc_target == c
        tp, fp = threshold_counts_np(mc_preds[:, c], positive, thr)
        wants["binned"].append(fixed_point_np(tp, fp, float(positive.sum()), float((~positive).sum()),
                                              thr.astype(np.float64), floor))
        tp, fp = (np.cumsum(np.bincount(buckets[keep, c], minlength=bins)[::-1])[::-1].astype(np.float64)
                  for keep in (positive, ~positive))
        wants["sketch"].append(fixed_point_np(tp, fp, tp[0], fp[0], sketch_thr, floor))

    mc = MetricCollection([getattr(tc, f"Binary{name}")(floor, thresholds=num_thr) for name in FIXED_POINT]
                          + [tc.BinaryAUROC(thresholds=num_thr)])
    log = StepLog("path F", tier_name, k3.BINNED_CONFMAT)
    torch.cuda.synchronize()
    k3.BINNED_CONFMAT.launches = 0
    k3.CURVE_COUNTS.launches = 0
    k2.SKETCH_UPDATE.launches = 0
    t0 = time.perf_counter()
    for i in range(total // batch):
        batch_vals = log(mc, bp[i * batch:(i + 1) * batch], bt[i * batch:(i + 1) * batch])
    result = mc.compute()
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    log.check(eager_first=4)  # eager: 4 launches on the first step (one per metric), then one per step
    if len(mc.compute_groups) != 1:
        raise AssertionError(f"path F: expected one compute group of the four curve metrics, got {mc.compute_groups}")
    for member in mc.values():
        check_confmat(f"path F {type(member).__name__}", member.metric_state["confmat"], b_tp, b_fp, b_pos, total - b_pos)
    for name, key in FIXED_POINT.items():
        check_pair(f"path F Binary{name}", result[f"Binary{name}"], b_want[key])
    check_value("path F BinaryAUROC", result["BinaryAUROC"], b_auroc)

    multiclass = {}
    for regime, kwargs, counter in (("binned", {"thresholds": num_thr}, k3.BINNED_CONFMAT),
                                    ("sketch", {"approx": "sketch", "sketch_bins": bins}, k2.SKETCH_UPDATE)):
        group = MetricCollection([getattr(tc, f"Multiclass{name}")(num_classes, floor, **kwargs) for name in FIXED_POINT])
        for member in group.values():
            member.fast_update = True  # the update-only graph tier
        group_log = StepLog(f"path F multiclass {regime}", tier_name, counter)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, total // 5, batch):
            group_log(group.update, mp[i:i + batch], mt[i:i + batch])
        values = group.compute()
        torch.cuda.synchronize()
        multiclass[f"{regime}_rows_per_s"] = (total // 5) / (time.perf_counter() - t0)
        group_log.check(eager_first=3)  # eager: 3 launches on the first update (one per metric), then 1
        multiclass[f"{regime}_values"] = [[float(x) for x in v] for pair in values.values() for v in pair]
        for name, key in FIXED_POINT.items():
            value, threshold = values[f"Multiclass{name}"]
            for c in range(num_classes):
                check_pair(f"path F Multiclass{name} {regime} class {c}", (value[c], threshold[c]), wants[regime][c][key])
    if k3.CURVE_COUNTS.launches:
        raise AssertionError("path F reached K3's direct body; the binned entry serves it")

    # calibration: ImageNet-shaped ECE on path B's logits, and the binary form on path C's scores
    ece_mc = tc.MulticlassCalibrationError(num_classes=1000, n_bins=15, ignore_index=-1)
    ece_b = tc.BinaryCalibrationError(n_bins=15)
    ece_mc.fast_update = ece_b.fast_update = True
    ece_log = StepLog("path F calibration", tier_name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, logits_b.shape[0], 1000):
        ece_log(ece_mc.update, logits_b[i:i + 1000], target_b[i:i + 1000])
    ece_mc_value = float(ece_mc.compute())
    calibration_s = time.perf_counter() - t0
    logits64 = logits_b.double().cpu().numpy()
    probs = np.exp(logits64 - logits64.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    target_np = target_b.cpu().numpy()
    check_value("path F MulticlassCalibrationError", ece_mc_value,
                calibration_np(probs.max(1), (probs.argmax(1) == target_np).astype(np.float64),
                               (target_np != -1).astype(np.float64), 15))
    for i in range(0, total, batch):
        ece_log(ece_b.update, bp[i:i + batch], bt[i:i + batch])
    ece_log.check(eager_first=0, groups=1)
    positive = b_preds > np.float32(0.5)
    conf = np.where(positive, b_preds, np.float32(1.0) - b_preds).astype(np.float64)
    ece_b_value = check_value("path F BinaryCalibrationError", ece_b.compute(),
                              calibration_np(conf, (positive == (b_target == 1)).astype(np.float64), np.ones(total), 15))
    summary = {
        "forward_per_s": (total // batch) / forward_s, "samples_per_s": total / forward_s, **multiclass,
        "calibration_1000_rows_per_s": logits_b.shape[0] / calibration_s,
        "values": {**{k: [float(x) for x in v] if isinstance(v, tuple) else float(v) for k, v in result.items()},
                   "MulticlassCalibrationError": ece_mc_value, "BinaryCalibrationError": ece_b_value},
        "last_batch": [[float(x) for x in v] if isinstance(v, tuple) else float(v) for v in batch_vals.values()],
        "device_ops_per_step": device_ops_per_step(mc, [(bp[i * batch:(i + 1) * batch], bt[i * batch:(i + 1) * batch])
                                                        for i in range(10)]),
    }
    return summary, k3.BINNED_CONFMAT.launches, k2.SKETCH_UPDATE.launches, log


def run_path_g(device, k1, tier_name: str = "graph"):
    """Path G, the benchmark's headline protocol (``bench.py:42-106``, data ``bench.py:35-39``) on one
    dispatch tier: ``sweep_fn`` over the stack, then ``update_batches`` + ``compute`` five times with a
    reset before each, ``buffered(32)`` against per-step updates, and an aggregation collection over
    the same stream cast to float32. Returns (summary, K1 launches)."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.aggregation import MaxMetric, MeanMetric, SumMetric
    from torchmetrics_tpu_torch.ops.dispatch import STATS

    num_classes, n_batches, batch = 5, 100, 10_000
    rng = np.random.RandomState(7)  # bench.py:35-39
    preds = rng.randint(0, num_classes, size=(n_batches, batch)).astype(np.int32)
    target = rng.randint(0, num_classes, size=(n_batches, batch)).astype(np.int32)
    sp, st = torch.from_numpy(preds).to(device), torch.from_numpy(target).to(device)
    counts, want = reference_values(preds.reshape(-1), target.reshape(-1), num_classes)
    fallbacks = STATS.n_fallbacks
    k1.BINCOUNT.launches = 0

    def check_result(name, result):
        for key, value in want.items():
            check_value(f"path G {name} {key}", result[key], value, TOL)

    def check_counts_of(name, mc):
        for member in mc.values():
            for key, value in counts.items():
                check_counts(f"path G {name} {type(member).__name__}.{key}", member.metric_state[key], value.astype(np.int64))

    mc = collection(num_classes, validate_args=False)
    mc(sp[0], st[0])  # forms the compute groups, as bench.py:78 does
    mc.reset()
    fn = mc.sweep_fn()
    sweeps = StepLog("path G sweep_fn", tier_name, k1.BINCOUNT)
    for _ in range(3):  # the first call captures, the later ones replay
        check_result("sweep_fn", sweeps(fn, sp, st))
    sweeps.check(eager_first=n_batches, per_graph=n_batches)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(sp, st)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    for member in mc.values():
        if int(member.metric_state["tp"].sum()):
            raise AssertionError("path G: sweep_fn changed the collection's persistent state")

    updates = StepLog("path G update_batches", tier_name, k1.BINCOUNT)

    def host_window():
        results = []
        for _ in range(5):
            mc.reset()
            updates(mc.update_batches, sp, st)
            results.append(mc.compute())
        torch.cuda.synchronize()
        return results

    host_window()
    seconds = []
    for _ in range(3):
        t0 = time.perf_counter()
        results = host_window()
        seconds.append(time.perf_counter() - t0)
    updates.check(eager_first=n_batches, per_graph=n_batches)
    for result in results:
        check_result("update_batches", result)
    check_counts_of("update_batches", mc)

    loop = collection(num_classes, validate_args=False)  # path A's per-step loop over the same stack
    for i in range(n_batches):
        loop(sp[i], st[i])
    buffered, stepped = collection(num_classes, validate_args=False), collection(num_classes, validate_args=False)
    for member in (*buffered.values(), *stepped.values()):
        member.fast_update = True  # the update-only graph tier for the per-step updates and the first batch
    buf = buffered.buffered(32)
    for i in range(n_batches):
        buf.update(sp[i], st[i])
        stepped.update(sp[i], st[i])
    buf.flush()
    for name in mc._modules:
        for other_name, other in (("the forward loop", loop), ("buffered(32)", buffered), ("per-step updates", stepped)):
            for key in counts:
                if not torch.equal(mc[name].metric_state[key], other[name].metric_state[key]):
                    raise AssertionError(f"path G: update_batches' {name}.{key} differs from {other_name}'s")
    buffered_values, stepped_values = buffered.compute(), stepped.compute()
    if any(not torch.equal(buffered_values[k], stepped_values[k]) for k in stepped_values):
        raise AssertionError("path G: buffered(32) differs from per-step updates")

    agg = MetricCollection({"mean": MeanMetric(), "max": MaxMetric(), "sum": SumMetric()})
    for member in agg.values():
        member.fast_update = True  # MaxMetric's full-state forward updates through it
    values = sp.float()
    agg(values[0])  # forms the groups: one per member, their states differ
    agg.reset()
    agg.update_batches(values)
    swept = agg.sweep_fn()(values)
    agg_want = {"mean": float(preds.mean(dtype=np.float64)), "max": float(preds.max()), "sum": float(preds.sum(dtype=np.int64))}
    for source, result in (("update_batches", agg.compute()), ("sweep_fn", swept)):
        for name, value in agg_want.items():
            check_value(f"path G aggregation {source} {name}", result[name], value, TOL * max(abs(value), 1.0))
    if STATS.n_fallbacks != fallbacks and tier_name == "graph":
        raise AssertionError(f"path G: eager fallbacks on the graph tier: {dict(STATS.fallbacks)}")
    summary = {
        "host_api_rate": 5 * n_batches / min(seconds), "wall_one_sweep_s": min(walls),
        "values": {k: float(v) for k, v in results[-1].items()}, "sweep": {k: float(v) for k, v in fn(sp, st).items()},
        "aggregation": {k: float(v) for k, v in swept.items()}, "update_batches_log": updates.line(),
        "sweep_log": sweeps.line(),
    }
    return summary, k1.BINCOUNT.launches


RETRIEVAL_TOL = 1e-5


def ranked_np(scores: np.ndarray) -> np.ndarray:
    """Indices of one query's documents by descending score, equal scores in reversed input order."""
    return np.lexsort((-np.arange(scores.shape[0]), -scores))


def tie_averaged_dcg_np(rel: np.ndarray, scores: np.ndarray, k: int) -> float:
    """sklearn's ``_tie_averaged_dcg``: each document of a group of equal scores gets the mean
    discount of the group's positions; discounts beyond ``k`` are 0."""
    discount = 1.0 / np.log2(np.arange(rel.shape[0]) + 2.0)
    discount[k:] = 0.0
    cumulative = np.cumsum(discount)
    _, inverse, counts = np.unique(-scores, return_inverse=True, return_counts=True)
    gains = np.zeros(counts.shape[0])
    np.add.at(gains, inverse, rel)
    ends = np.cumsum(counts) - 1
    sums = np.diff(np.concatenate([[0.0], cumulative[ends]]))
    return float((gains / counts * sums).sum())


def query_value_np(name: str, scores: np.ndarray, rel: np.ndarray, top_k=None, adaptive_k: bool = False) -> float:
    """One query's value from its valid documents, in input order, by the metric's definition."""
    n = rel.shape[0]
    ranked = rel[ranked_np(scores)]
    k = n if top_k is None else min(top_k, n)
    positives, negatives = rel.sum(), n - rel.sum()
    if name == "RetrievalMAP":
        precision_at = np.cumsum(ranked) / np.arange(1, n + 1)
        hits = ranked[:k]
        return float((precision_at[:k] * hits).sum() / hits.sum()) if hits.sum() else 0.0
    if name == "RetrievalMRR":
        first = np.flatnonzero(ranked[:k] > 0)
        return 1.0 / (first[0] + 1) if first.size else 0.0
    if name == "RetrievalPrecision":
        denominator = k if (top_k is None or adaptive_k) else top_k
        return float(ranked[:k].sum() / denominator) if positives else 0.0
    if name == "RetrievalRecall":
        return float(ranked[:k].sum() / positives) if positives else 0.0
    if name == "RetrievalFallOut":
        return float((1 - ranked[:k]).sum() / negatives) if negatives else 0.0
    if name == "RetrievalHitRate":
        return float(ranked[:k].sum() > 0)
    if name == "RetrievalRPrecision":
        return float(ranked[:int(positives)].sum() / positives) if positives else 0.0
    if name == "RetrievalNormalizedDCG":
        ideal = np.sort(rel)[::-1][:k] / np.log2(np.arange(2, k + 2))
        return tie_averaged_dcg_np(rel, scores, k) / ideal.sum() if ideal.sum() > 0 else 0.0
    raise ValueError(name)


def queries_np(indexes: np.ndarray, preds: np.ndarray, target: np.ndarray, ignore_index=None):
    """``(scores, relevance)`` of each query with a valid document, its documents in input order."""
    order = np.argsort(indexes, kind="stable")
    ids, starts = np.unique(indexes[order], return_index=True)
    out = []
    for lo, hi in zip(starts, list(starts[1:]) + [order.shape[0]]):
        docs = order[lo:hi]
        if ignore_index is not None:
            docs = docs[target[docs] != ignore_index]
        if docs.size:
            out.append((preds[docs].astype(np.float64), target[docs].astype(np.float64)))
    return out


def aggregate_np(values: list, aggregation):
    if not values:
        return 0.0
    values = np.asarray(values, np.float64)
    if callable(aggregation):
        return aggregation(values)
    return float({"mean": np.mean, "median": np.median, "min": np.min, "max": np.max}[aggregation](values))


def retrieval_np(name: str, queries, top_k=None, adaptive_k: bool = False, action: str = "neg", aggregation="mean"):
    """A scalar retrieval metric over ``queries_np``'s queries, with the empty-query action: a
    query is empty without positives (FallOut: without negatives)."""
    values = []
    for scores, rel in queries:
        empty = (rel.shape[0] - rel.sum() if name == "RetrievalFallOut" else rel.sum()) == 0
        if empty:
            if action == "error":
                raise ValueError("an empty query")
            if action != "skip":
                values.append(1.0 if action == "pos" else 0.0)
            continue
        values.append(query_value_np(name, scores, rel, top_k, adaptive_k))
    return aggregate_np(values, aggregation)


def retrieval_curve_np(queries, max_k=None, adaptive_k: bool = False, action: str = "neg", aggregation="mean"):
    """(precisions, recalls, ks) of ``RetrievalPrecisionRecallCurve`` for k = 1..max_k."""
    max_k = max(rel.shape[0] for _, rel in queries) if max_k is None else max_k
    ks = np.arange(1, max_k + 1)
    rows = []
    for scores, rel in queries:
        if rel.sum() == 0:
            if action == "error":
                raise ValueError("an empty query")
            if action != "skip":
                rows.append(np.full((2, max_k), 1.0 if action == "pos" else 0.0))
            continue
        n = rel.shape[0]
        ranked = rel[ranked_np(scores)]
        hits = np.concatenate([np.cumsum(ranked), np.full(max(max_k - n, 0), ranked.sum())])[:max_k]
        rows.append(np.stack([hits / (np.minimum(ks, n) if adaptive_k else ks), hits / rel.sum()]))
    if not rows:
        return np.zeros(max_k), np.zeros(max_k), ks
    table = np.stack(rows)  # (queries, 2, max_k)
    if callable(aggregation):
        curves = np.asarray([[aggregation(table[:, j, col]) for col in range(max_k)] for j in (0, 1)])
    else:
        curves = {"mean": np.mean, "median": np.median, "min": np.min, "max": np.max}[aggregation](table, axis=0)
    return curves[0], curves[1], ks


def run_path_h(device, tier_name: str = "graph"):
    """Path H, BASELINE config #5 at full size (``bench.py:2182-2214``, seed 9): ``RetrievalMAP`` and
    ``RetrievalNormalizedDCG`` over 2^20 documents and 10,000 sorted query ids, three ``reset`` +
    ``update`` + ``compute`` per window, best of three windows, scored ``3 * n / best``. Each compute
    after the first must give the first one's bits; values within 1e-5 of ``retrieval_np``."""
    from torchmetrics_tpu_torch.ops.dispatch import STATS
    from torchmetrics_tpu_torch.retrieval import RetrievalMAP, RetrievalNormalizedDCG

    n, n_queries = 1 << 20, 10_000
    rng = np.random.RandomState(9)  # bench.py:2193-2197, in its order
    preds = rng.rand(n).astype(np.float32)
    target = rng.randint(0, 2, size=n).astype(np.int32)
    indexes = np.sort(rng.randint(0, n_queries, size=n)).astype(np.int32)
    p, t, i = (torch.from_numpy(x).to(device) for x in (preds, target, indexes))
    queries = queries_np(indexes, preds, target)
    out = {}
    for name, cls in (("RetrievalMAP", RetrievalMAP), ("RetrievalNormalizedDCG", RetrievalNormalizedDCG)):
        STATS.reset()
        m = cls(device=device)
        m.update(p, t, indexes=i)
        first = m.compute()
        torch.cuda.synchronize()
        computes, walls, seconds = [], [], []
        for _ in range(5):  # the wall of one compute, its update done and synchronised before
            m.reset()
            m.update(p, t, indexes=i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            computes.append(m.compute())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

        def window():
            results = []
            for _ in range(3):
                m.reset()
                m.update(p, t, indexes=i)
                results.append(m.compute())
            torch.cuda.synchronize()
            return results

        window()
        for _ in range(3):
            t0 = time.perf_counter()
            computes += window()
            seconds.append(time.perf_counter() - t0)
        if any(not torch.equal(c, first) for c in computes):
            raise AssertionError(f"path H {name} ({tier_name} tier): two computes of the same state differ in their bits")
        compute_fallbacks = {k: v for k, v in STATS.fallbacks.items() if k[1] != "update"}
        update_fallbacks = {k: v for k, v in STATS.fallbacks.items() if k[1] == "update"}
        if set(update_fallbacks) - {(name, "update", "fast_update_class_off")}:
            raise AssertionError(f"path H {name}: unexpected update fallbacks {update_fallbacks}")
        calls = 1 + len(computes) + 3  # the first compute, the timed ones, the untimed window
        if tier_name == "graph" and (compute_fallbacks or STATS.captures != 1 or STATS.replays != calls):
            raise AssertionError(f"path H {name} (graph tier): {STATS.captures} captures, {STATS.replays} replays, fallbacks"
                                 f" {compute_fallbacks}; expected one capture, a replay per compute and no fallback")
        want = retrieval_np(name, queries)
        check_value(f"path H {name} ({tier_name} tier)", first, want, RETRIEVAL_TOL)
        del m
        out[name] = {"value": float(first), "numpy": want, "samples_per_s": 3 * n / min(seconds),
                     "compute_wall_ms": min(walls) * 1e3, "compute_wall_ms_median": float(np.median(walls)) * 1e3,
                     "captures": STATS.captures, "replays": STATS.replays, "compute_fallbacks": sum(compute_fallbacks.values()),
                     "update_fallbacks": sum(update_fallbacks.values())}
    out["RetrievalPrecisionRecallCurve"] = curve_at_full_size(device, p, t, i, queries, tier_name)
    return out


def curve_at_full_size(device, p, t, i, queries, tier_name: str):
    """``RetrievalPrecisionRecallCurve`` over path H's 2^20 documents, ``max_k`` read from the
    longest query: the ``(documents, 128)`` tiles of ``curve_counts`` and the ``(documents, K)``
    result are the largest transients of the port. Returns the compute's wall, the device memory
    it allocated at its peak beyond the state and the memory still reserved after it (a captured
    graph keeps its private pool), and checks the curves against numpy."""
    from torchmetrics_tpu_torch.ops.dispatch import STATS
    from torchmetrics_tpu_torch.retrieval import RetrievalPrecisionRecallCurve

    STATS.reset()
    m = RetrievalPrecisionRecallCurve(device=device)
    m.update(p, t, indexes=i)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    before, reserved = torch.cuda.memory_allocated(device), torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    precision, recall, ks = m.compute()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) - before
    # what stays reserved after the compute: on the graph tier, the captured graph's private pool
    held = torch.cuda.memory_reserved(device) - reserved
    want_p, want_r, want_k = retrieval_curve_np(queries)
    label = f"path H RetrievalPrecisionRecallCurve ({tier_name} tier)"
    if ks.cpu().tolist() != want_k.tolist():
        raise AssertionError(f"{label}: k runs to {int(ks[-1])}, numpy to {int(want_k[-1])}")
    err = max(float(np.max(np.abs(c.double().cpu().numpy() - w))) for c, w in ((precision, want_p), (recall, want_r)))
    if not err <= RETRIEVAL_TOL:
        raise AssertionError(f"{label}: the curves differ from numpy by {err}")
    compute_fallbacks = {k: v for k, v in STATS.fallbacks.items() if k[1] != "update"}
    if tier_name == "graph" and (compute_fallbacks or STATS.captures != 1):
        raise AssertionError(f"{label}: {STATS.captures} captures, fallbacks {compute_fallbacks}")
    return {"value": (precision.cpu().numpy().tobytes(), recall.cpu().numpy().tobytes()), "max_k": int(ks[-1]),
            "compute_wall_ms": wall * 1e3, "peak_gib": peak / 2**30, "held_gib": held / 2**30, "max_abs_err": err}


RAGGED_SCALARS = ("RetrievalMAP", "RetrievalMRR", "RetrievalPrecision", "RetrievalRecall", "RetrievalFallOut",
                  "RetrievalHitRate", "RetrievalRPrecision", "RetrievalNormalizedDCG")


def ragged_configs():
    """(class name, keyword arguments) of the ragged set: every empty action, every aggregation,
    ``top_k`` and ``adaptive_k`` over all ten metrics."""
    configs = []
    for name in RAGGED_SCALARS + ("RetrievalPrecisionRecallCurve",):
        for action in ("neg", "pos", "skip", "error"):
            configs.append((name, {"empty_target_action": action}))
        for aggregation in ("median", "min", "max", "callable"):
            configs.append((name, {"aggregation": aggregation}))
        if name not in ("RetrievalRPrecision", "RetrievalPrecisionRecallCurve"):
            configs.append((name, {"top_k": 5}))
    configs += [("RetrievalPrecision", {"top_k": 5, "adaptive_k": True}), ("RetrievalPrecision", {"top_k": 200, "adaptive_k": True}),
                ("RetrievalPrecisionRecallCurve", {"max_k": 12, "adaptive_k": True}),
                ("RetrievalRecallAtFixedPrecision", {"min_precision": 0.4}),
                ("RetrievalRecallAtFixedPrecision", {"min_precision": 0.6, "max_k": 20, "empty_target_action": "skip"})]
    return configs


def run_path_h_ragged(device, tier_name: str = "graph"):
    """Path H's ragged set: 50,000 documents over 1,000 unsorted query ids with tied scores,
    ``ignore_index=-1``, queries without positives, without negatives and with every document
    ignored, fed in two updates; every config of ``ragged_configs`` against ``retrieval_np`` within
    1e-5 (``top_k`` values exactly), ``"error"`` raising. Returns ({config: values}, compute fallbacks)."""
    import torchmetrics_tpu_torch.retrieval as retrieval
    from torchmetrics_tpu_torch.ops.dispatch import STATS

    n, n_queries = 50_000, 1_000
    rng = np.random.RandomState(19)
    indexes = rng.randint(0, n_queries, n).astype(np.int64)
    preds = (rng.randint(0, 32, n) / 32.0).astype(np.float32)
    binary, graded = rng.randint(0, 2, n), rng.randint(0, 4, n)
    ignored = rng.rand(n) < 0.1
    for target in (binary, graded):
        target[indexes % 17 == 0] = 0  # no positives
        target[indexes % 29 == 3] = 1  # no negatives
        target[ignored | (indexes % 23 == 5)] = -1  # ignored documents, and queries with every document ignored
    data = {}
    for kind, target in (("binary", binary), ("graded", graded)):
        data[kind] = ([torch.from_numpy(x[:20_000]).to(device) for x in (preds, target, indexes)],
                      [torch.from_numpy(x[20_000:]).to(device) for x in (preds, target, indexes)], queries_np(indexes, preds, target, -1))
    STATS.reset()
    results = {}
    for name, kwargs in ragged_configs():
        kind = "graded" if name == "RetrievalNormalizedDCG" else "binary"
        first, second, queries = data[kind]
        agg = kwargs.get("aggregation", "mean")
        metric_kwargs = dict(kwargs, ignore_index=-1)
        if agg == "callable":
            metric_kwargs["aggregation"] = lambda v: v.to(torch.float64).mean()
        m = getattr(retrieval, name)(**metric_kwargs, device=device)
        for p, t, i in (first, second):
            m.update(p, t, indexes=i)
        label = f"path H ragged {name} {kwargs} ({tier_name} tier)"
        np_kwargs = {k: v for k, v in kwargs.items() if k in ("top_k", "adaptive_k", "max_k")}
        np_kwargs.update(action=m.empty_target_action, aggregation=np.mean if agg == "callable" else agg)
        if np_kwargs["action"] == "error":
            try:
                m.compute()
            except ValueError:
                results[(name, str(kwargs))] = "raised"
                continue
            raise AssertionError(f"{label}: the 'error' action did not raise")
        if name in ("RetrievalPrecisionRecallCurve", "RetrievalRecallAtFixedPrecision"):
            got = m.compute()
            want_p, want_r, want_k = retrieval_curve_np(queries, **{k: v for k, v in np_kwargs.items() if k != "top_k"})
            if name == "RetrievalRecallAtFixedPrecision":
                mask = want_p >= kwargs["min_precision"]
                best = int(np.argmax(np.where(mask, want_r, -1.0)))
                want = (want_r[best], want_k[best]) if mask.any() else (0.0, want_k.max())
                check_value(label + " recall", got[0], float(want[0]), RETRIEVAL_TOL)
                if int(got[1]) != int(want[1]):
                    raise AssertionError(f"{label}: best k {int(got[1])}, numpy gives {int(want[1])}")
            else:
                for curve, ref in ((got[0], want_p), (got[1], want_r)):
                    err = float(np.max(np.abs(curve.double().cpu().numpy() - ref))) if ref.size == curve.numel() else np.inf
                    if not err <= RETRIEVAL_TOL:
                        raise AssertionError(f"{label}: curve differs from numpy by {err}")
                if got[2].cpu().tolist() != want_k.tolist():
                    raise AssertionError(f"{label}: k values {got[2].cpu().tolist()[:5]}..., numpy {want_k.tolist()[:5]}...")
            results[(name, str(kwargs))] = tuple(x.cpu().numpy().tobytes() for x in got)
        else:
            got = m.compute()
            check_value(label, got, retrieval_np(name, queries, **np_kwargs), RETRIEVAL_TOL)
            results[(name, str(kwargs))] = got.cpu().numpy().tobytes()
    compute_fallbacks = {k: v for k, v in STATS.fallbacks.items() if k[1] != "update"}
    if tier_name == "graph" and compute_fallbacks:
        raise AssertionError(f"path H ragged (graph tier): compute fallbacks {compute_fallbacks}")
    return results, STATS.captures, STATS.replays


def run_path_i(device, k1, preds_a: np.ndarray, target_a: np.ndarray, pa, ta, tier_name: str = "graph"):
    """Path I, composition and dtype, on path A's data: ``MulticlassAccuracy + MulticlassF1Score``
    and ``abs(a - b)`` through 20 ``forward`` calls of 10,000 and ``compute``, against numpy, each
    step one graph replay and one K1 launch per operand; then ``MeanMetric`` over the same labels
    cast to float32, ``set_dtype(torch.float64)`` after five steps, whose next step must capture one
    new graph with no fallback. Returns (values, K1 launches, MeanMetric's values, each composition's
    ``StepLog`` line)."""
    from torchmetrics_tpu_torch.aggregation import MeanMetric
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy, MulticlassF1Score
    from torchmetrics_tpu_torch.ops.dispatch import STATS

    num_classes, batch, steps = 5, 10_000, 20

    def pair():
        return (MulticlassAccuracy(num_classes=num_classes, average="micro", validate_args=False, device=device),
                MulticlassF1Score(num_classes=num_classes, average="macro", validate_args=False, device=device))

    acc1, f1_1 = pair()
    acc2, f1_2 = pair()
    summed, gap = acc1 + f1_1, abs(acc2 - f1_2)
    logs = {"sum": StepLog("path I acc + f1", tier_name, k1.BINCOUNT), "gap": StepLog("path I abs(acc - f1)", tier_name, k1.BINCOUNT)}
    k1.BINCOUNT.launches = 0
    values = {}
    for s in range(steps):
        b = slice(s * batch, (s + 1) * batch)
        _, want = reference_values(preds_a[b], target_a[b], num_classes)
        got_sum, got_gap = logs["sum"](summed, pa[b], ta[b]), logs["gap"](gap, pa[b], ta[b])
        check_value(f"path I step {s} acc + f1", got_sum, want["MulticlassAccuracy"] + want["MulticlassF1Score"], TOL)
        check_value(f"path I step {s} abs(acc - f1)", got_gap, abs(want["MulticlassAccuracy"] - want["MulticlassF1Score"]), TOL)
        values[f"step{s}"] = (float(got_sum), float(got_gap))
    for log in logs.values():  # each operand's forward: one graph replay, or two eager K1 launches a step
        log.check(eager_first=2, groups=2) if tier_name == "graph" else log.check(eager_first=2, per_graph=2)
    launches = k1.BINCOUNT.launches
    _, want = reference_values(preds_a[:steps * batch], target_a[:steps * batch], num_classes)
    check_value("path I acc + f1 compute", summed.compute(), want["MulticlassAccuracy"] + want["MulticlassF1Score"], TOL)
    check_value("path I abs(acc - f1) compute", gap.compute(), abs(want["MulticlassAccuracy"] - want["MulticlassF1Score"]), TOL)
    values["compute"] = (float(summed.compute()), float(gap.compute()))

    mean = MeanMetric(device=device)
    floats = pa.float()
    mean_values = []
    for s in range(10):
        if s == 5:
            mean.set_dtype(torch.float64)
            before = (STATS.captures, STATS.replays, STATS.n_fallbacks)
        mean_values.append(mean(floats[s * batch:(s + 1) * batch]))
        if s == 5 and tier_name == "graph":
            moved = tuple(a - b for a, b in zip((STATS.captures, STATS.replays, STATS.n_fallbacks), before))
            if moved != (1, 1, 0):
                raise AssertionError(f"path I: the step after set_dtype made {moved} (captures, replays, fallbacks),"
                                     " expected one new capture, its replay and no fallback")
    total = mean.compute()
    if total.dtype != torch.float64:
        raise AssertionError(f"path I: MeanMetric computes in {total.dtype} after set_dtype(torch.float64)")
    check_value("path I MeanMetric", total, float(preds_a[:10 * batch].mean(dtype=np.float64)), TOL)
    mean_bits = [v.cpu().numpy().tobytes() for v in mean_values] + [total.cpu().numpy().tobytes()]
    return values, launches, mean_bits, {name: log.line() for name, log in logs.items()}


J_TOL = 1e-5


def check_close(name: str, got, want: float, tol: float = J_TOL) -> float:
    """``got`` within ``tol`` of ``want``, relative where ``|want| > 1`` (coverage errors, hinge
    sums), absolute below: MCC and kappa of random labels lie near 0, where only an absolute bound
    holds."""
    got = float(got)
    if not np.isfinite(got) or abs(got - want) > tol * max(1.0, abs(want)):
        raise AssertionError(f"{name} = {got}, numpy gives {want} (tolerance {tol})")
    return got


def confmat_values_np(cm: np.ndarray, weights=None) -> dict:
    """float64 Cohen's kappa, MCC and the macro Jaccard index of a ``(C, C)`` confusion matrix,
    and the macro specificity, Hamming distance and Dice of its stat scores: the formulas of the
    JAX package, evaluated in numpy."""
    cm = cm.astype(np.float64)
    c_ = cm.shape[0]
    sum0, sum1 = cm.sum(0), cm.sum(1)
    idx = np.arange(c_, dtype=np.float64)
    w = {None: 1.0 - np.eye(c_), "linear": np.abs(idx[:, None] - idx[None, :]),
         "quadratic": (idx[:, None] - idx[None, :]) ** 2}[weights]
    kappa = 1.0 - (w * cm).sum() / (w * np.outer(sum1, sum0) / sum0.sum()).sum()
    s, c = cm.sum(), np.trace(cm)
    cov_ytyp, cov_ypyp, cov_ytyt = c * s - (sum1 * sum0).sum(), s**2 - (sum0**2).sum(), s**2 - (sum1**2).sum()
    mcc = cov_ytyp / np.sqrt(cov_ypyp * cov_ytyt) if cov_ypyp * cov_ytyt else 0.0
    tp = np.diag(cm)
    fp, fn = sum0 - tp, sum1 - tp
    tn = s - tp - fp - fn
    present = (tp + fp + fn) > 0
    return {"kappa": kappa, "mcc": mcc, "jaccard": float(div_np(tp, sum0 + sum1 - tp)[(sum0 + sum1) > 0].mean()),
            "specificity": float(div_np(tn, tn + fp)[present].mean()),
            "hamming": float(1 - div_np(tp, tp + fn)[present].mean()),
            "dice": float(div_np(2 * tp, 2 * tp + fp + fn)[present].mean()), "tp": tp, "fp": fp, "tn": tn, "fn": fn}


def softmax_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    e = np.exp(x - x.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def hinge_np(probs: np.ndarray, target: np.ndarray):
    """float64 sums of the Crammer-Singer hinge and the one-vs-all ``(C,)`` hinge over the rows."""
    rows = np.arange(target.shape[0])
    true = probs[rows, target]
    others = probs.copy()
    others[rows, target] = -np.inf
    cs = np.maximum(1.0 - (true - others.max(axis=1)), 0.0).sum()
    ova = np.maximum(1.0 + probs, 0.0)
    ova[rows, target] = np.maximum(1.0 - true, 0.0)
    return cs, ova.sum(axis=0)


def ranking_np(preds: np.ndarray, target: np.ndarray, valid=None) -> dict:
    """Sums over the rows of the coverage error, the label-ranking AP and the label-ranking loss,
    sklearn's definitions in float64, vectorised over rows (in chunks) and labels."""
    preds = preds.astype(np.float64)
    valid = np.ones(target.shape, bool) if valid is None else valid
    out = {"MultilabelCoverageError": 0.0, "MultilabelRankingAveragePrecision": 0.0, "MultilabelRankingLoss": 0.0}
    for lo in range(0, preds.shape[0], 2000):
        p, v = preds[lo:lo + 2000], valid[lo:lo + 2000]
        rel, irr = (target[lo:lo + 2000] == 1) & v, (target[lo:lo + 2000] == 0) & v
        min_rel = np.where(rel, p, np.inf).min(axis=1)
        out["MultilabelCoverageError"] += np.where(rel.any(1), ((p >= min_rel[:, None]) & v).sum(1), 0).sum()
        ge = p[:, None, :] >= p[:, :, None]  # [n, i, j]: score_j >= score_i
        rank, l_rank = (ge & v[:, None, :]).sum(-1), (ge & rel[:, None, :]).sum(-1)
        n_rel, n_valid = rel.sum(1), v.sum(1)
        lrap = np.where(rel, l_rank / np.maximum(rank, 1), 0.0).sum(1) / np.maximum(n_rel, 1)
        out["MultilabelRankingAveragePrecision"] += np.where((n_rel == 0) | (n_rel == n_valid), 1.0, lrap).sum()
        bad = (ge & rel[:, :, None] & irr[:, None, :]).sum((1, 2))  # relevant i, irrelevant j, score_j >= score_i
        pairs = n_rel * irr.sum(1)
        out["MultilabelRankingLoss"] += np.where(pairs > 0, bad / np.maximum(pairs, 1), 0.0).sum()
    return out


def ranking_loop_np(name: str, preds: np.ndarray, target: np.ndarray, ignore_index=None) -> float:
    """One ranking metric, sample by sample in float64 (sklearn's definitions; ignored labels dropped)."""
    values = []
    for p, t in zip(preds.astype(np.float64), target):
        keep = t != ignore_index if ignore_index is not None else np.ones(t.shape, bool)
        p, t = p[keep], t[keep]
        rel = t == 1
        if name == "MultilabelCoverageError":
            values.append(float(np.sum(p >= p[rel].min())) if rel.any() else 0.0)
        elif name == "MultilabelRankingAveragePrecision":
            values.append(1.0 if not rel.any() or rel.all() else
                          float(np.mean([np.sum(p[rel] >= p[i]) / np.sum(p >= p[i]) for i in np.flatnonzero(rel)])))
        else:
            pairs = rel.sum() * (~rel).sum()
            values.append(sum(np.sum(p[~rel] >= p[i]) for i in np.flatnonzero(rel)) / pairs if pairs else 0.0)
    return float(np.mean(values))


def fairness_np(stats: np.ndarray) -> dict:
    """The demographic-parity and equal-opportunity results of ``[tp, fp, tn, fn]`` counts per group."""
    tp, fp, tn, fn = (stats[:, i].astype(np.float64) for i in range(4))
    out = {}
    for prefix, rates in (("DP", div_np(tp + fp, tp + fp + tn + fn)), ("EO", div_np(tp, tp + fn))):
        lo, hi = int(np.argmin(rates)), int(np.argmax(rates))
        out[f"{prefix}_{lo}_{hi}"] = float(div_np(rates[lo], rates[hi]))
    return out


def loop(log, fn, batches):
    """``fn`` over the batches through ``log``; (last value, seconds with the card synchronised)."""
    sync()
    t0 = time.perf_counter()
    for batch in batches:
        value = log(fn, *batch)
    sync()
    return value, time.perf_counter() - t0


def path_j_data(device, rows_j2: int = 100_000, rows_j3: int = 1_000_000):
    """Path J's inputs on ``device``: J1 is path B's data (``main``), J2 100,000 x 80 multilabel rows
    (COCO's 80 labels, 5% relevant, seed 21), J3 1,000,000 binary scores in 8 groups (seed 23)."""
    rng = np.random.RandomState(21)
    ml_target = (rng.rand(rows_j2, 80) < 0.05).astype(np.int32)
    ml_preds = (rng.rand(rows_j2, 80) * 0.52 + ml_target * 0.48).astype(np.float32)
    rng = np.random.RandomState(23)
    b_scores = rng.rand(rows_j3).astype(np.float32)
    b_target = (rng.rand(rows_j3) < b_scores * 0.8 + 0.1).astype(np.int32)
    b_groups = rng.randint(0, 8, rows_j3).astype(np.int32)
    host = {"ml_preds": ml_preds, "ml_target": ml_target, "b_scores": b_scores, "b_target": b_target,
            "b_groups": b_groups}
    return host, {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def path_j_metrics(part: str):
    """The metrics of J1, J2 or J3, by loop, as ``chip_smoke.py`` and ``profile_port.py`` drive them."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch import classification as c

    if part == "J1":
        return {
            "confmat": MetricCollection([c.MulticlassCohenKappa(1000, ignore_index=-1, weights="quadratic"),
                                         c.MulticlassMatthewsCorrCoef(1000, ignore_index=-1),
                                         c.MulticlassJaccardIndex(1000, ignore_index=-1)]),
            "stat": MetricCollection([c.MulticlassSpecificity(1000, average="macro", ignore_index=-1),
                                      c.MulticlassHammingDistance(1000, average="macro", ignore_index=-1)]),
            "dice": c.Dice(num_classes=1000, average="macro"),
            "hinge": MetricCollection({"cs": c.MulticlassHingeLoss(1000, ignore_index=-1),
                                       "ova": c.MulticlassHingeLoss(1000, multiclass_mode="one-vs-all", ignore_index=-1)}),
        }
    if part == "J2":
        return {
            "confmat": MetricCollection([c.MultilabelJaccardIndex(80), c.MultilabelMatthewsCorrCoef(80)]),
            "stat": c.MultilabelHammingDistance(80),
            "exact": c.MultilabelExactMatch(80),
            "ranking": MetricCollection([c.MultilabelRankingAveragePrecision(80), c.MultilabelRankingLoss(80),
                                         c.MultilabelCoverageError(80)]),
        }
    return {
        "rates": c.BinaryGroupStatRates(8),
        "confmat": MetricCollection([c.BinaryCohenKappa(), c.BinaryMatthewsCorrCoef()]),
        "stat": c.BinarySpecificity(),
        "hinge": c.BinaryHingeLoss(squared=True),
    }


#: per loop of J1-J3: whether each of its graphs launches K1 once (else it launches no K1), and
#: its compute groups
J_LOOPS = {"J1": {"confmat": (True, 1), "stat": (True, 1), "dice": (True, 1), "hinge": (False, 2)},
           "J2": {"confmat": (True, 1), "stat": (True, 1), "exact": (False, 1), "ranking": (False, 3)},
           "J3": {"rates": (True, 1), "confmat": (True, 1), "stat": (True, 1), "hinge": (False, 1)}}


def run_j_loops(part: str, metrics: dict, batches, k1, tier_name: str, lines: dict) -> float:
    """Each loop of ``part`` over the batches with its ``StepLog`` checks (no fallback on the graph
    tier); returns the seconds of all loops. J3's loops other than ``rates`` take no groups."""
    from torchmetrics_tpu_torch.ops.dispatch import STATS

    seconds = 0.0
    for name, mc in metrics.items():
        counts_k1, groups = J_LOOPS[part][name]
        log = StepLog(f"path {part} {name}", tier_name, k1.BINCOUNT if counts_k1 else None)
        before = STATS.n_fallbacks
        _, s = loop(log, mc, batches if part != "J3" or name == "rates" else [b[:2] for b in batches])
        seconds += s
        log.check(eager_first=len(getattr(mc, "_modules", [mc])), groups=groups)
        if tier_name == "graph" and STATS.n_fallbacks != before:
            raise AssertionError(f"path {part} {name}: {STATS.n_fallbacks - before} eager fallbacks on the graph tier"
                                 f" ({STATS.fallbacks})")
        lines[f"{part} {name}"] = log.line()
    return seconds


def run_path_j(device, k1, k2, logits_b, target_b, tier_name: str = "graph", **sizes):
    """Path J, the rest of classification at full width on one dispatch tier: J1 on path B's
    ImageNet-shaped logits (C = 1000, 50 x 1,000 rows, ``ignore_index=-1`` on 1%), J2 at COCO's 80
    labels (100,000 rows in 10 batches), J3 binary fairness over 1,000,000 scores in 8 groups (100
    calls of 10,000), each loop through ``forward`` with its ``StepLog``; then J4, the ragged set
    (``run_path_j_ragged``). Counts must equal numpy's, values float64 numpy's within 1e-5.
    Returns (summary for the tier comparison, K1 launches, timing lines)."""
    from torchmetrics_tpu_torch.classification import BinaryFairness
    from torchmetrics_tpu_torch.ops.dispatch import STATS

    host, dev = path_j_data(device, **sizes)
    n2, n3 = host["ml_target"].shape[0], host["b_scores"].shape[0]
    k1.BINCOUNT.launches = 0
    k2.HIST_PAIR.launches = 0
    values, lines = {}, {}

    # ---- J1: C = 1000 on path B's logits
    t_b = target_b.cpu().numpy()
    keep = t_b != -1
    logits_np = logits_b.cpu().numpy()
    cm = np.bincount(t_b[keep] * 1000 + logits_np.argmax(axis=1)[keep], minlength=1000**2).reshape(1000, 1000)
    want = confmat_values_np(cm, "quadratic")
    probs = np.concatenate([softmax_np(logits_np[i:i + 10_000]) for i in range(0, logits_np.shape[0], 10_000)])
    cs, ova = hinge_np(probs[keep], t_b[keep])
    j1 = path_j_metrics("J1")
    batches = [(logits_b[i:i + 1000], target_b[i:i + 1000]) for i in range(0, logits_b.shape[0], 1000)]  # 50 calls
    seconds = run_j_loops("J1", j1, batches, k1, tier_name, lines)
    res = {**j1["confmat"].compute(), **j1["stat"].compute(), "Dice": j1["dice"].compute(), **j1["hinge"].compute()}
    check_counts("path J1 confmat", j1["confmat"]["MulticlassCohenKappa"].metric_state["confmat"], cm)
    for key, got in zip(("tp", "fp", "tn", "fn"), (j1["stat"]["MulticlassSpecificity"].metric_state[k] for k in ("tp", "fp", "tn", "fn"))):
        check_counts(f"path J1 MulticlassSpecificity.{key}", got, want[key].astype(np.int64))
    for key, w in (("MulticlassCohenKappa", want["kappa"]), ("MulticlassMatthewsCorrCoef", want["mcc"]),
                   ("MulticlassJaccardIndex", want["jaccard"]), ("MulticlassSpecificity", want["specificity"]),
                   ("MulticlassHammingDistance", want["hamming"]), ("Dice", want["dice"]),
                   ("cs", cs / keep.sum())):
        values[f"J1 {key}"] = check_close(f"path J1 {key}", res[key], w)
    ova_err = float(np.abs(res["ova"].double().cpu().numpy() - ova / keep.sum()).max())
    if not ova_err <= J_TOL:
        raise AssertionError(f"path J1 one-vs-all hinge: max abs err {ova_err} against numpy")
    values["J1 ova"] = tuple(res["ova"].tolist())
    lines["J1"] = (f"{len(batches) / seconds:.1f} forward/s (one call of each of the four loops),"
                   f" {logits_b.shape[0] / seconds:.4g} samples/s,"
                   f" {device_ops_per_step(j1['confmat'], batches[:10]):.1f} device operations/step of the confmat group")

    # ---- J2: multilabel at COCO's 80 labels
    ml_p01 = host["ml_preds"] > np.float32(0.5)
    ml_counts = stat_counts_np(ml_p01, host["ml_target"])  # per label
    tp, fp, tn, fn = ml_counts
    cm2 = np.array([[tn.sum(), fp.sum()], [fn.sum(), tp.sum()]])
    rank = ranking_np(host["ml_preds"], host["ml_target"])
    j2 = path_j_metrics("J2")
    batches = [(dev["ml_preds"][i:i + n2 // 10], dev["ml_target"][i:i + n2 // 10]) for i in range(0, n2, n2 // 10)]
    seconds = run_j_loops("J2", j2, batches, k1, tier_name, lines)
    res = {**j2["confmat"].compute(), "MultilabelHammingDistance": j2["stat"].compute(),
           "MultilabelExactMatch": j2["exact"].compute(), **j2["ranking"].compute()}
    ml_cm = np.stack([np.stack([tn, fp], -1), np.stack([fn, tp], -1)], -2).astype(np.int64)
    check_counts("path J2 confmat", j2["confmat"]["MultilabelJaccardIndex"].metric_state["confmat"], ml_cm)
    check_counts("path J2 MultilabelHammingDistance.tp", j2["stat"].metric_state["tp"], tp.astype(np.int64))
    exact = float(np.all(ml_p01 == host["ml_target"].astype(bool), axis=1).sum())
    check_counts("path J2 MultilabelExactMatch.correct", j2["exact"].metric_state["correct"], np.asarray(exact, np.float32))
    for key, w in (("MultilabelJaccardIndex", float(div_np(tp, tp + fp + fn).mean())),
                   ("MultilabelMatthewsCorrCoef", confmat_values_np(cm2)["mcc"]),
                   ("MultilabelHammingDistance", float(1 - div_np(tp + tn, tp + tn + fp + fn).mean())),
                   ("MultilabelExactMatch", exact / n2), *((k, v / n2) for k, v in rank.items())):
        values[f"J2 {key}"] = check_close(f"path J2 {key}", res[key], w)
    lines["J2"] = (f"{len(batches) / seconds:.2f} forward/s (one call of each of the four loops), {n2 / seconds:.4g} samples/s,"
                   f" {device_ops_per_step(j2['ranking'], batches[:5]):.1f} device operations/step of the ranking collection")

    # ---- J3: binary fairness, 8 groups
    b01 = (host["b_scores"] > np.float32(0.5)).astype(np.int64)
    fused = np.bincount(host["b_groups"] * 4 + host["b_target"] * 2 + b01, minlength=32).reshape(8, 2, 2)
    stats = np.stack([fused[:, 1, 1], fused[:, 0, 1], fused[:, 0, 0], fused[:, 1, 0]], axis=-1)
    b_cm = fused.sum(0)
    b_want = confmat_values_np(b_cm)
    hinge_sq = float((np.maximum(1 - host["b_scores"].astype(np.float64) * (2 * host["b_target"] - 1), 0) ** 2).mean())
    j3 = path_j_metrics("J3")
    step = n3 // 100
    batches = [(dev["b_scores"][i:i + step], dev["b_target"][i:i + step], dev["b_groups"][i:i + step])
               for i in range(0, n3, step)]
    fairness = BinaryFairness(8, task="all")
    before = STATS.n_fallbacks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):  # jit_compute=False: each forward runs eagerly, one K1 launch
        launches, replays = k1.BINCOUNT.launches, STATS.replays
        fair_batch = fairness(*batch)
        if k1.BINCOUNT.launches - launches != 1 or STATS.replays != replays or k2.HIST_PAIR.launches:
            raise AssertionError(f"path J3 BinaryFairness step {i}: {k1.BINCOUNT.launches - launches} K1 launches,"
                                 f" {STATS.replays - replays} graph replays, {k2.HIST_PAIR.launches} K2 launches")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fair_fallbacks = STATS.n_fallbacks - before
    if fair_fallbacks != len(batches) or STATS.fallbacks[("BinaryFairness", "forward", "not_fusable")] < len(batches):
        raise AssertionError(f"path J3 BinaryFairness: {fair_fallbacks} fallbacks, expected one not_fusable per forward")
    lines["J3 fairness"] = f"{len(batches) / seconds:.1f} forward/s (eager by design: jit_compute=False)"
    seconds += run_j_loops("J3", j3, batches, k1, tier_name, lines)
    if k2.HIST_PAIR.launches:
        raise AssertionError(f"path J3: K2 launched {k2.HIST_PAIR.launches} times; the fairness count is one K1 launch")
    check_counts("path J3 BinaryFairness.stats", fairness.metric_state["stats"].long(), stats)
    check_counts("path J3 BinaryGroupStatRates.stats", j3["rates"].metric_state["stats"].long(), stats)
    check_counts("path J3 binary confmat", j3["confmat"]["BinaryCohenKappa"].metric_state["confmat"], b_cm)
    fair, fair_want = fairness.compute(), fairness_np(stats)
    if list(fair) != list(fair_want):
        raise AssertionError(f"path J3 BinaryFairness keys {list(fair)}, numpy gives {list(fair_want)}")
    for key, w in fair_want.items():
        values[f"J3 {key}"] = check_close(f"path J3 {key}", fair[key], w)
    rates = j3["rates"].compute()
    for g in range(8):
        err = np.abs(rates[f"group_{g}"].double().cpu().numpy() - stats[g] / stats[g].sum()).max()
        if not err <= J_TOL:
            raise AssertionError(f"path J3 BinaryGroupStatRates group_{g}: max abs err {err}")
        values[f"J3 group_{g}"] = tuple(rates[f"group_{g}"].tolist())
    res = {**j3["confmat"].compute(), "BinarySpecificity": j3["stat"].compute(), "BinaryHingeLoss": j3["hinge"].compute()}
    tn_, fp_ = b_cm[0, 0], b_cm[0, 1]
    for key, w in (("BinaryCohenKappa", b_want["kappa"]), ("BinaryMatthewsCorrCoef", b_want["mcc"]),
                   ("BinarySpecificity", tn_ / (tn_ + fp_)), ("BinaryHingeLoss", hinge_sq)):
        values[f"J3 {key}"] = check_close(f"path J3 {key}", res[key], w)
    values["J3 last batch"] = {k: float(v) for k, v in fair_batch.items()}
    lines["J3"] = (f"{len(batches) / seconds:.1f} forward/s (one call of each of the five loops), {n3 / seconds:.4g} samples/s,"
                   f" {device_ops_per_step(fairness, batches[:10]):.1f} device operations per BinaryFairness forward")

    values["J4"], ragged_launches = run_path_j_ragged(device, k1, tier_name)
    lines["J4"] = (f"{len(J4_CLASSES)} class configurations and {len(J4_FUNCTIONS) + len(J4_EDGES)} functional calls"
                   f" agree with the CPU, K1 launches {ragged_launches}")
    return values, k1.BINCOUNT.launches, lines


def ragged_j_data():
    """J4's inputs, 2,000 samples (seed 29), as numpy arrays: multiclass at C = 7 (class 5 absent
    from targets and labels; the third of four batches of 500 all ``ignore_index``), multilabel at
    L = 6 with tied scores, binary scores, and the samplewise ``(500, ..., 4)`` forms."""
    rng = np.random.RandomState(29)
    n, c_, l_ = 2000, 7, 6

    def ignored(t, share=0.1):
        t = t.copy()
        t[rng.rand(*t.shape) < share] = -1
        t[1000:1500] = -1  # an all-ignored batch
        return t

    mc_labels = rng.choice([0, 1, 2, 3, 4, 6], n)
    mc_target = rng.choice([0, 1, 2, 3, 4, 6], n)
    ml_target = rng.randint(0, 2, (n, l_))
    bin_target = rng.randint(0, 2, n)
    data = {
        "mc_scores": rng.randn(n, c_).astype(np.float32), "mc_labels": mc_labels, "mc_target": mc_target,
        "mc_target_ign": ignored(mc_target),
        "mc3_scores": rng.randn(n, c_, 4).astype(np.float32), "mc3_labels": rng.randint(0, c_, (n, 4)),
        "mc3_target": rng.randint(0, c_, (n, 4)),
        "ml_preds": (np.round(rng.rand(n, l_) * 4) / 4).astype(np.float32), "ml_target": ml_target,
        "ml_target_ign": ignored(ml_target), "ml3_preds": rng.rand(n, l_, 4).astype(np.float32),
        "ml3_target": rng.randint(0, 2, (n, l_, 4)),
        "bin_scores": rng.rand(n).astype(np.float32), "bin_labels": rng.randint(0, 2, n), "bin_target": bin_target,
        "bin_target_ign": ignored(bin_target), "bin2_scores": rng.rand(n, 4).astype(np.float32),
        "bin2_target": rng.randint(0, 2, (n, 4)), "groups": rng.randint(0, 4, n),
        "bin_pair_scores": rng.rand(n, 2).astype(np.float32),
    }
    data["ml_target_all"] = data["ml_target"].copy()
    data["ml_target_all"][:3] = 1  # every label relevant
    data["ml_target_all"][3:6] = 0  # no relevant label
    return data


#: J4's classes: (name, constructor arguments, input arrays); all 31 classes of the slice, through
#: their wrappers too, over every average, multidim_average, top_k, ignore_index, kappa weight and
#: hinge mode
J4_CLASSES = [
    ("BinarySpecificity", {"ignore_index": -1}, ("bin_scores", "bin_target_ign")),
    ("BinarySpecificity", {"multidim_average": "samplewise"}, ("bin2_scores", "bin2_target")),
    ("MulticlassSpecificity", {"num_classes": 7, "ignore_index": -1}, ("mc_scores", "mc_target_ign")),
    ("MulticlassSpecificity", {"num_classes": 7, "average": "micro", "top_k": 2}, ("mc_scores", "mc_target")),
    ("MulticlassSpecificity", {"num_classes": 7, "average": "weighted", "multidim_average": "samplewise"},
     ("mc3_labels", "mc3_target")),
    ("MultilabelSpecificity", {"num_labels": 6, "average": "none", "ignore_index": -1}, ("ml_preds", "ml_target_ign")),
    ("MultilabelSpecificity", {"num_labels": 6, "multidim_average": "samplewise"}, ("ml3_preds", "ml3_target")),
    ("Specificity", {"task": "multiclass", "num_classes": 7, "average": "macro"}, ("mc_labels", "mc_target")),
    ("BinaryHammingDistance", {"threshold": 0.3}, ("bin_scores", "bin_target")),
    ("BinaryHammingDistance", {"multidim_average": "samplewise", "ignore_index": -1}, ("bin2_scores", "bin2_target")),
    ("MulticlassHammingDistance", {"num_classes": 7, "average": "none", "ignore_index": -1}, ("mc_labels", "mc_target_ign")),
    ("MulticlassHammingDistance", {"num_classes": 7, "top_k": 3, "average": "macro"}, ("mc_scores", "mc_target")),
    ("MultilabelHammingDistance", {"num_labels": 6, "average": "micro", "ignore_index": -1}, ("ml_preds", "ml_target_ign")),
    ("MultilabelHammingDistance", {"num_labels": 6, "average": "weighted"}, ("ml_preds", "ml_target")),
    ("HammingDistance", {"task": "multilabel", "num_labels": 6}, ("ml_preds", "ml_target")),
    ("BinaryJaccardIndex", {"ignore_index": -1}, ("bin_scores", "bin_target_ign")),
    ("MulticlassJaccardIndex", {"num_classes": 7, "ignore_index": -1}, ("mc_scores", "mc_target_ign")),
    ("MulticlassJaccardIndex", {"num_classes": 7, "average": "micro", "ignore_index": 3}, ("mc_labels", "mc_target")),
    ("MulticlassJaccardIndex", {"num_classes": 7, "average": "weighted"}, ("mc_labels", "mc_target")),
    ("MulticlassJaccardIndex", {"num_classes": 7, "average": "none"}, ("mc_scores", "mc_target")),
    ("MultilabelJaccardIndex", {"num_labels": 6, "ignore_index": -1}, ("ml_preds", "ml_target_ign")),
    ("MultilabelJaccardIndex", {"num_labels": 6, "average": "micro"}, ("ml_preds", "ml_target")),
    ("JaccardIndex", {"task": "binary"}, ("bin_scores", "bin_target")),
    ("BinaryCohenKappa", {"ignore_index": -1}, ("bin_scores", "bin_target_ign")),
    ("BinaryCohenKappa", {"weights": "linear"}, ("bin_labels", "bin_target")),
    ("MulticlassCohenKappa", {"num_classes": 7, "weights": "quadratic", "ignore_index": -1}, ("mc_scores", "mc_target_ign")),
    ("MulticlassCohenKappa", {"num_classes": 7, "weights": "linear"}, ("mc_labels", "mc_target")),
    ("MulticlassCohenKappa", {"num_classes": 7}, ("mc_scores", "mc_target")),
    ("CohenKappa", {"task": "binary", "weights": "quadratic"}, ("bin_scores", "bin_target")),
    ("BinaryMatthewsCorrCoef", {"ignore_index": -1}, ("bin_scores", "bin_target_ign")),
    ("MulticlassMatthewsCorrCoef", {"num_classes": 7, "ignore_index": -1}, ("mc_labels", "mc_target_ign")),
    ("MultilabelMatthewsCorrCoef", {"num_labels": 6, "ignore_index": -1}, ("ml_preds", "ml_target_ign")),
    ("MatthewsCorrCoef", {"task": "multiclass", "num_classes": 7}, ("mc_scores", "mc_target")),
    ("MulticlassExactMatch", {"num_classes": 7}, ("mc3_labels", "mc3_target")),
    ("MulticlassExactMatch", {"num_classes": 7, "multidim_average": "samplewise"}, ("mc3_scores", "mc3_target")),
    ("MultilabelExactMatch", {"num_labels": 6, "ignore_index": -1}, ("ml_preds", "ml_target_ign")),
    ("MultilabelExactMatch", {"num_labels": 6, "multidim_average": "samplewise"}, ("ml3_preds", "ml3_target")),
    ("ExactMatch", {"task": "multilabel", "num_labels": 6}, ("ml_preds", "ml_target")),
    ("Dice", {"num_classes": 7, "average": "macro"}, ("mc_scores", "mc_target")),
    ("Dice", {"num_classes": 7, "average": "none", "ignore_index": 2}, ("mc_labels", "mc_target")),
    ("Dice", {"num_classes": 7, "average": "samples"}, ("mc_labels", "mc_target")),
    ("Dice", {"num_classes": 7, "average": "micro", "top_k": 2}, ("mc_scores", "mc_target")),
    ("Dice", {"multiclass": False, "average": "macro"}, ("bin_labels", "bin_target")),
    ("Dice", {"threshold": 0.3}, ("bin_scores", "bin_target")),
    ("BinaryHingeLoss", {}, ("bin_scores", "bin_target")),
    ("BinaryHingeLoss", {"squared": True, "ignore_index": -1}, ("bin_scores", "bin_target_ign")),
    ("MulticlassHingeLoss", {"num_classes": 7, "ignore_index": -1}, ("mc_scores", "mc_target_ign")),
    ("MulticlassHingeLoss", {"num_classes": 7, "squared": True, "multiclass_mode": "one-vs-all"}, ("mc_scores", "mc_target")),
    ("HingeLoss", {"task": "multiclass", "num_classes": 7, "multiclass_mode": "one-vs-all"}, ("mc3_scores", "mc3_target")),
    ("MultilabelCoverageError", {"num_labels": 6}, ("ml_preds", "ml_target_all")),
    ("MultilabelCoverageError", {"num_labels": 6, "ignore_index": -1}, ("ml_preds", "ml_target_ign")),
    ("MultilabelRankingAveragePrecision", {"num_labels": 6}, ("ml_preds", "ml_target_all")),
    ("MultilabelRankingAveragePrecision", {"num_labels": 6, "ignore_index": -1}, ("ml_preds", "ml_target_ign")),
    ("MultilabelRankingLoss", {"num_labels": 6}, ("ml_preds", "ml_target_all")),
    ("MultilabelRankingLoss", {"num_labels": 6, "ignore_index": -1}, ("ml_preds", "ml_target_ign")),
    ("BinaryGroupStatRates", {"num_groups": 4, "ignore_index": -1}, ("bin_scores", "bin_target_ign", "groups")),
    ("BinaryFairness", {"num_groups": 4}, ("bin_scores", "bin_target", "groups")),
    ("BinaryFairness", {"num_groups": 4, "task": "demographic_parity"}, ("bin_scores", "bin_target", "groups")),
    ("BinaryFairness", {"num_groups": 4, "task": "equal_opportunity", "ignore_index": -1},
     ("bin_scores", "bin_target_ign", "groups")),
]

#: J4's functional entries: (name, input arrays, keyword arguments); all 33 of the slice
J4_FUNCTIONS = [
    ("binary_specificity", ("bin_scores", "bin_target_ign"), {"ignore_index": -1}),
    ("multiclass_specificity", ("mc_scores", "mc_target"), {"num_classes": 7, "top_k": 2, "average": "weighted"}),
    ("multilabel_specificity", ("ml3_preds", "ml3_target"), {"num_labels": 6, "multidim_average": "samplewise"}),
    ("specificity", ("bin_scores", "bin_target"), {"task": "binary"}),
    ("binary_hamming_distance", ("bin2_scores", "bin2_target"), {"multidim_average": "samplewise"}),
    ("multiclass_hamming_distance", ("mc_labels", "mc_target_ign"), {"num_classes": 7, "ignore_index": -1}),
    ("multilabel_hamming_distance", ("ml_preds", "ml_target"), {"num_labels": 6, "average": "none"}),
    ("hamming_distance", ("mc_scores", "mc_target"), {"task": "multiclass", "num_classes": 7}),
    ("binary_jaccard_index", ("bin_scores", "bin_target"), {"threshold": 0.7}),
    ("multiclass_jaccard_index", ("mc_labels", "mc_target"), {"num_classes": 7, "average": "micro", "ignore_index": 3}),
    ("multilabel_jaccard_index", ("ml_preds", "ml_target_ign"), {"num_labels": 6, "average": "weighted", "ignore_index": -1}),
    ("jaccard_index", ("ml_preds", "ml_target"), {"task": "multilabel", "num_labels": 6}),
    ("binary_matthews_corrcoef", ("bin_labels", "bin_target"), {}),
    ("multiclass_matthews_corrcoef", ("mc_scores", "mc_target_ign"), {"num_classes": 7, "ignore_index": -1}),
    ("multilabel_matthews_corrcoef", ("ml_preds", "ml_target"), {"num_labels": 6, "threshold": 0.6}),
    ("matthews_corrcoef", ("bin_scores", "bin_target"), {"task": "binary"}),
    ("binary_cohen_kappa", ("bin_scores", "bin_target_ign"), {"weights": "quadratic", "ignore_index": -1}),
    ("multiclass_cohen_kappa", ("mc_labels", "mc_target"), {"num_classes": 7, "weights": "linear"}),
    ("cohen_kappa", ("mc_scores", "mc_target"), {"task": "multiclass", "num_classes": 7}),
    ("multiclass_exact_match", ("mc3_labels", "mc3_target"), {"num_classes": 7, "multidim_average": "samplewise"}),
    ("multilabel_exact_match", ("ml_preds", "ml_target_ign"), {"num_labels": 6, "ignore_index": -1}),
    ("exact_match", ("mc3_scores", "mc3_target"), {"task": "multiclass", "num_classes": 7}),
    ("binary_hinge_loss", ("bin_scores", "bin_target_ign"), {"squared": True, "ignore_index": -1}),
    ("multiclass_hinge_loss", ("mc_scores", "mc_target"), {"num_classes": 7, "multiclass_mode": "one-vs-all"}),
    ("hinge_loss", ("mc_scores", "mc_target_ign"), {"task": "multiclass", "num_classes": 7, "ignore_index": -1}),
    ("multilabel_coverage_error", ("ml_preds", "ml_target_ign"), {"num_labels": 6, "ignore_index": -1}),
    ("multilabel_ranking_average_precision", ("ml_preds", "ml_target_all"), {"num_labels": 6}),
    ("multilabel_ranking_loss", ("ml_preds", "ml_target_ign"), {"num_labels": 6, "ignore_index": -1}),
    ("binary_groups_stat_rates", ("bin_scores", "bin_target", "groups"), {"num_groups": 4}),
    ("binary_fairness", ("bin_scores", "bin_target_ign", "groups"), {"ignore_index": -1}),
    ("demographic_parity", ("bin_scores", "groups"), {"threshold": 0.4}),
    ("equal_opportunity", ("bin_scores", "bin_target", "groups"), {}),
    ("dice", ("bin_pair_scores", "bin_target"), {"multiclass": False, "average": "macro"}),
]

#: edge inputs of J4: a single group, tied fairness rates, ranking ties, an all-ignored call
J4_EDGES = [
    ("binary_fairness", {"preds": np.random.RandomState(31).rand(50).astype(np.float32),
                         "target": np.random.RandomState(32).randint(0, 2, 50), "groups": np.zeros(50, np.int64)}, {}),
    ("binary_fairness", {"preds": np.array([1, 1, 0, 0, 1, 1, 0, 0]), "target": np.ones(8, np.int64),
                         "groups": np.array([0, 0, 1, 1, 2, 2, 3, 3])}, {}),
    ("multilabel_ranking_loss", {"preds": np.full((6, 4), 0.5, np.float32), "target": np.eye(6, 4, dtype=np.int64)},
     {"num_labels": 4}),
    ("multiclass_matthews_corrcoef", {"preds": np.arange(10) % 3, "target": np.full(10, -1)},
     {"num_classes": 3, "ignore_index": -1}),
    ("multiclass_jaccard_index", {"preds": np.arange(10) % 3, "target": np.full(10, -1)},
     {"num_classes": 3, "ignore_index": -1}),
]


def _leaves(value):
    """A result as a flat list of (key, float32 tensor on the CPU); a tuple's entries keyed by position."""
    if isinstance(value, dict):
        return [(k, v.detach().cpu()) for k, v in value.items()]
    if isinstance(value, tuple):
        return [(str(i), v.detach().cpu()) for i, v in enumerate(value)]
    return [("", value.detach().cpu())]


def _agree(name: str, card, cpu, exact: bool = False) -> list:
    """The card's result equals the CPU's (its plain versions) within 1e-5 (NaN where the CPU has
    NaN; bit for bit when ``exact``); returns the card's values."""
    got, want = _leaves(card), _leaves(cpu)
    if [k for k, _ in got] != [k for k, _ in want]:
        raise AssertionError(f"path {name}: keys {[k for k, _ in got]} on the card, {[k for k, _ in want]} on the CPU")
    out = []
    for (key, g), (_, w) in zip(got, want):
        g64, w64 = g.double().numpy(), w.double().numpy()
        same_nan = np.array_equal(np.isnan(g64), np.isnan(w64))
        ok = np.array_equal(g64, w64, equal_nan=True) if exact else \
            same_nan and np.all(np.abs(np.nan_to_num(g64 - w64)) <= J_TOL * np.maximum(1.0, np.abs(np.nan_to_num(w64))))
        if g.shape != w.shape or not ok:
            raise AssertionError(f"path {name}{key}: card {g.tolist()}, CPU {w.tolist()}")
        out.append((key, tuple("nan" if np.isnan(x) else x for x in g64.ravel().tolist())))  # NaN != NaN
    return out


def run_path_j_ragged(device, k1, tier_name: str = "graph"):
    """J4: every class of the slice through ``forward`` over four batches of 500 and ``compute``,
    and every functional entry, on the card and on the CPU (the plain versions, which the CPU tests
    hold to the JAX package), with the edge cases. The card must agree with the CPU within 1e-5
    and, in the integer-valued states, exactly; the ranking metrics also with a per-sample numpy
    loop; on the graph tier no fallback but the list states' and ``BinaryFairness``'s forward.
    Returns (the card's values, K1 launches)."""
    from torchmetrics_tpu_torch import classification as c
    from torchmetrics_tpu_torch import functional as f
    from torchmetrics_tpu_torch.ops.dispatch import STATS

    data = ragged_j_data()
    launches = k1.BINCOUNT.launches
    values = {}
    for i, (name, kwargs, keys) in enumerate(J4_CLASSES):
        label = f"{name}#{i}"
        on_card, on_cpu = getattr(c, name)(device=device, **kwargs), getattr(c, name)(device="cpu", **kwargs)
        batches = [[torch.from_numpy(data[k][lo:lo + 500]) for k in keys] for lo in range(0, 2000, 500)]
        want = [on_cpu(*batch) for batch in batches]  # first, so that the fallbacks counted are the card's
        before = STATS.n_fallbacks
        for lo, batch, w in zip(range(0, 2000, 500), batches, want):
            values[f"{label} batch {lo}"] = _agree(f"J4 {label}", on_card(*[b.to(device) for b in batch]), w)
        values[label] = _agree(f"J4 {label}", on_card.compute(), on_cpu.compute())
        for key, state in on_cpu.metric_state.items():
            card_state = on_card.metric_state[key]
            if isinstance(state, list):
                state, card_state = torch.cat(state), torch.cat(card_state)
            if not state.is_floating_point() or torch.equal(state, state.round()):
                _agree(f"J4 {label}.{key}", card_state, state, exact=True)
        expected = 4 if on_card._lists or not on_card.jit_compute else 0  # the forwards that are not fused
        if tier_name == "graph" and STATS.n_fallbacks - before != expected:
            raise AssertionError(f"path J4 {label}: {STATS.n_fallbacks - before} fallbacks, expected {expected}")
        if "Ranking" in name or "Coverage" in name:
            ii = kwargs.get("ignore_index")
            want = ranking_loop_np(name, data[keys[0]], data[keys[1]], ii)
            check_close(f"path J4 {label} against the per-sample loop", values[label][0][1][0], want)
    for name, keys, kwargs in J4_FUNCTIONS:
        args = [torch.from_numpy(data[k]) for k in keys]
        values[name] = _agree(f"J4 {name}", getattr(f, name)(*[a.to(device) for a in args], **kwargs),
                              getattr(f, name)(*args, **kwargs))
    for i, (name, inputs, kwargs) in enumerate(J4_EDGES):
        args = [torch.from_numpy(np.asarray(v)) for v in inputs.values()]
        values[f"edge {i} {name}"] = _agree(f"J4 edge {i} {name}", getattr(f, name)(*[a.to(device) for a in args], **kwargs),
                                            getattr(f, name)(*args, **kwargs))
    if [k for k, _ in values["edge 1 binary_fairness"]] != ["DP_1_0", "EO_1_0"]:
        raise AssertionError(f"path J4 tied fairness rates: keys {values['edge 1 binary_fairness']}, expected the first groups")
    return values, k1.BINCOUNT.launches - launches


# ------------------------------------------------------------------ path K: regression
K_TOL = 1e-5
#: float32's unit roundoff, for the bounds of float32 sums
U32 = 2.0 ** -24
#: adds beyond a binary tree in one reduction's serial chain, assumed for the bounds
K_SERIAL = 8
#: K2's column with targets of mean 100 and std 1, where Σy² - (Σy)²/n cancels in float32
K2_CANCEL = 5


def sync() -> None:
    """Wait for the card, where there is one (the CPU dry runs of the paths have none)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def gamma(n_batches: int, batch: int) -> float:
    """First-order relative error bound of a float32 state sum over ``n_batches`` batches of
    ``batch`` rows: a tree of depth log2(batch) within a batch, ``K_SERIAL`` more serial adds, and
    one add per batch into the state."""
    return (n_batches + int(np.ceil(np.log2(max(batch, 2)))) + K_SERIAL) * U32


def check_rel(name: str, got, want: float, tol: float = K_TOL, bound: float = 0.0) -> float:
    """``got`` within ``max(tol * |want|, bound)`` of ``want``; returns the error."""
    got = float(got)
    err = abs(got - want)
    if not np.isfinite(got) or err > max(tol * abs(want), bound):
        raise AssertionError(f"{name} = {got!r}, float64 gives {want!r} (error {err:.3g}, tolerance"
                             f" {max(tol * abs(want), bound):.3g})")
    return err


def path_k_metrics(part: str, device=None):
    """The collections of K1 and K2, as ``chip_smoke.py``, ``profile_port.py`` and the tests drive them."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch import regression as r

    kw = {} if device is None else {"device": device}
    if part == "K1":
        return MetricCollection({
            "mse": r.MeanSquaredError(**kw), "rmse": r.MeanSquaredError(squared=False, **kw),
            "mae": r.MeanAbsoluteError(**kw), "r2": r.R2Score(**kw), "rse": r.RelativeSquaredError(**kw),
            "explained_variance": r.ExplainedVariance(**kw), "pearson": r.PearsonCorrCoef(**kw),
            "concordance": r.ConcordanceCorrCoef(**kw), "mape": r.MeanAbsolutePercentageError(**kw),
            "smape": r.SymmetricMeanAbsolutePercentageError(**kw), "wmape": r.WeightedMeanAbsolutePercentageError(**kw),
            "log_cosh": r.LogCoshError(**kw), "minkowski": r.MinkowskiDistance(p=3, **kw),
        })
    return MetricCollection({
        "mse": r.MeanSquaredError(num_outputs=8, **kw), "r2_raw": r.R2Score(multioutput="raw_values", **kw),
        "r2_weighted": r.R2Score(multioutput="variance_weighted", **kw),
        "explained_variance": r.ExplainedVariance(multioutput="raw_values", **kw),
        "pearson": r.PearsonCorrCoef(num_outputs=8, **kw), "log_cosh": r.LogCoshError(num_outputs=8, **kw),
    })


def path_k_data(part: str, rows: int = 1_000_000, batch: int = 10_000):
    """K1: (pred, target) pairs of a model of prices or latencies (lognormal targets, mean about 75,
    a wide spread; seed 29). K2: 8 targets per row of other means and spreads, column 5 of mean 100
    and std 1 (seed 31). As ``(rows // batch, batch[, 8])`` float32 stacks."""
    if part == "K1":
        rng = np.random.RandomState(29)
        target = rng.lognormal(4.0, 0.8, rows)
        preds = target * rng.lognormal(0.0, 0.2, rows) + rng.randn(rows) * 5
        return preds.astype(np.float32).reshape(-1, batch), target.astype(np.float32).reshape(-1, batch)
    rng = np.random.RandomState(31)
    means = np.array([0.0, 5.0, -3.0, 20.0, 1.0, 100.0, 0.5, 2.0])
    stds = np.array([1.0, 2.0, 0.5, 10.0, 3.0, 1.0, 0.2, 4.0])
    target = rng.randn(rows, 8) * stds + means
    preds = target + rng.randn(rows, 8) * stds * 0.5
    return preds.astype(np.float32).reshape(-1, batch, 8), target.astype(np.float32).reshape(-1, batch, 8)


def regression_np(preds: np.ndarray, target: np.ndarray) -> dict:
    """K1's values in float64, from the definitions (centred sums, not the moment sums)."""
    p, t = preds.astype(np.float64).ravel(), target.astype(np.float64).ravel()
    d = p - t
    rss, tss = np.sum(d * d), np.sum((t - t.mean()) ** 2)
    e = t - p
    cov = np.sum((p - p.mean()) * (t - t.mean()))
    vp, vt = np.sum((p - p.mean()) ** 2), np.sum((t - t.mean()) ** 2)
    n = len(t)
    return {
        "mse": rss / n, "rmse": np.sqrt(rss / n), "mae": np.mean(np.abs(d)), "r2": 1 - rss / tss, "rse": rss / tss,
        "explained_variance": 1 - np.var(e) / np.var(t), "pearson": cov / np.sqrt(vp * vt),
        "concordance": 2 * cov / (n - 1) / (vp / (n - 1) + vt / (n - 1) + (p.mean() - t.mean()) ** 2),
        "mape": np.mean(np.abs(d) / np.maximum(np.abs(t), 1.17e-06)),
        "smape": np.mean(2 * np.abs(d) / np.maximum(np.abs(t) + np.abs(p), 1.17e-06)),
        "wmape": np.sum(np.abs(d)) / max(np.sum(np.abs(t)), 1.17e-06),
        "log_cosh": np.mean(np.abs(d) + np.log1p(np.exp(-2 * np.abs(d))) - np.log(2.0)),
        "minkowski": np.sum(np.abs(d) ** 3) ** (1 / 3),
    }


def moments_np(preds: np.ndarray, target: np.ndarray, n_batches: int, batch: int) -> dict:
    """Per column of ``(N, d)`` float64 data: R², explained variance and their float32 error
    bounds. The port forms ``tss = Σy² - Σy·Σy/n`` and the variances from moment sums, as the JAX
    package does; each sum's error is at most ``gamma * Σ|term|``, so
    ``δtss <= gamma (Σy² + 2|ȳ| Σ|y|) + 2 u Σy²`` and ``δR² <= (δrss + |rss / tss| δtss) / tss``."""
    g = gamma(n_batches, batch)
    p, t = preds.astype(np.float64), target.astype(np.float64)
    n = t.shape[0]
    e = t - p
    rss, tss = np.sum(e * e, 0), np.sum((t - t.mean(0)) ** 2, 0)
    s2, s1 = np.sum(t * t, 0), np.sum(np.abs(t), 0)
    d_tss = g * (s2 + 2 * np.abs(t.mean(0)) * s1) + 2 * U32 * s2
    d_rss = g * rss
    num, den = np.var(e, 0), np.var(t, 0)
    d_num = (g * (np.sum(e * e, 0) + 2 * np.abs(e.mean(0)) * np.sum(np.abs(e), 0)) + 2 * U32 * np.sum(e * e, 0)) / n
    return {"r2": 1 - rss / tss, "r2_bound": (d_rss + np.abs(rss / tss) * d_tss) / tss,
            "r2_weighted": 1 - rss.sum() / tss.sum(),
            "r2_weighted_bound": (d_rss.sum() + rss.sum() / tss.sum() * d_tss.sum()) / tss.sum(),
            "ev": 1 - num / den, "ev_bound": (d_num + np.abs(num / den) * d_tss / n) / den,
            "mse": np.mean(e * e, 0), "pearson": np.array([np.corrcoef(p[:, i], t[:, i])[0, 1] for i in range(p.shape[1])]),
            "log_cosh": np.mean(np.abs(e) + np.log1p(np.exp(-2 * np.abs(e))) - np.log(2.0), 0)}


def run_path_k1(device, tier_name: str = "graph", rows: int = 1_000_000, batch: int = 10_000):
    """K1, an evaluation loop of a regression model: the 13-metric collection through ``forward``
    over ``rows // batch`` calls, each batch value against float64 numpy; ``compute``; then ``reset``
    + ``update_batches`` + ``compute`` over the same stack, bit-equal to the forward loop's. On the
    graph tier the only fallbacks are the Pearson group's (``full_state_update``: each member's own
    eager forward). Returns (values for the tier comparison, timing line)."""
    from torchmetrics_tpu_torch.ops.dispatch import STATS

    preds, target = path_k_data("K1", rows, batch)
    dev = [torch.from_numpy(a).to(device) for a in (preds, target)]
    batches = [(dev[0][i], dev[1][i]) for i in range(preds.shape[0])]
    mc = path_k_metrics("K1", device)
    log = StepLog("path K1", tier_name)
    before = dict(STATS.fallbacks)
    sync()
    t0 = time.perf_counter()
    steps = [log(mc, *b) for b in batches]
    sync()
    seconds = time.perf_counter() - t0
    fallbacks = {k: v - before.get(k, 0) for k, v in STATS.fallbacks.items() if v != before.get(k, 0)}
    allowed = {("group_forward", "group_not_fusable"), ("update", "fast_update_class_off")}
    if tier_name == "graph" and not {k[1:] for k in fallbacks} <= allowed:
        raise AssertionError(f"path K1: fallbacks {fallbacks} on the graph tier beyond the Pearson group's")
    errors = {}
    for i in range(len(batches)):
        want = regression_np(preds[i], target[i])
        for key, w in want.items():
            errors[key] = max(errors.get(key, 0.0), check_rel(f"path K1 batch {i} {key}", steps[i][key], w))
    final = mc.compute()
    want = regression_np(preds, target)
    for key, w in want.items():
        errors[f"{key} (all)"] = check_rel(f"path K1 {key}", final[key], w)
    values = {k: v.cpu().numpy().tobytes() for k, v in final.items()}
    mc.reset()
    sync()
    t0 = time.perf_counter()
    mc.update_batches(*dev)
    swept = mc.compute()
    sync()
    sweep_s = time.perf_counter() - t0
    swept = {k: v.cpu().numpy().tobytes() for k, v in swept.items()}
    if swept != values:
        raise AssertionError("path K1: reset + update_batches + compute differs from the forward loop's compute")
    groups = [g for g in mc.compute_groups.values() if len(g) > 1]
    line = (f"{len(batches) / seconds:.1f} forward/s, {rows / seconds:.4g} samples/s; {log.line()};"
            f" update_batches + compute {sweep_s * 1e3:.2f} ms; groups {groups}; fallbacks {fallbacks};"
            f" max relative error against float64 {max(errors[k] / max(abs(want[k.split(' ')[0]]), 1e-30) for k in errors if '(all)' in k):.3g}")
    return {"values": values, "steps": [{k: float(v) for k, v in s.items()} for s in steps]}, line, errors


def run_path_k2(device, tier_name: str = "graph", rows: int = 1_000_000, batch: int = 10_000):
    """K2, multi-target regression: 8 outputs, the collection through ``forward`` and ``compute``,
    every value against float64 numpy within 1e-5 relative, or within the float32 bound of the
    moment sums where it is larger (R² and explained variance; column 5 cancels). Returns (values,
    line, the cancelling column's errors and bounds)."""
    preds, target = path_k_data("K2", rows, batch)
    dev = [torch.from_numpy(a).to(device) for a in (preds, target)]
    batches = [(dev[0][i], dev[1][i]) for i in range(preds.shape[0])]
    mc = path_k_metrics("K2", device)
    log = StepLog("path K2", tier_name)
    _, seconds = loop(log, mc, batches)
    res = mc.compute()
    n_batches = preds.shape[0]
    want = moments_np(preds.reshape(-1, 8), target.reshape(-1, 8), n_batches, batch)
    cancel = {}
    for i in range(8):
        for key, got, w, bound in (("mse", res["mse"][i], want["mse"][i], 0.0),
                                   ("r2_raw", res["r2_raw"][i], want["r2"][i], want["r2_bound"][i]),
                                   ("explained_variance", res["explained_variance"][i], want["ev"][i], want["ev_bound"][i]),
                                   ("pearson", res["pearson"][i], want["pearson"][i], 0.0),
                                   ("log_cosh", res["log_cosh"][i], want["log_cosh"][i], 0.0)):
            err = check_rel(f"path K2 {key}[{i}]", got, w, bound=bound)
            if i == K2_CANCEL and bound:
                cancel[key] = (err, bound)
    cancel["r2_weighted"] = (check_rel("path K2 r2_weighted", res["r2_weighted"], want["r2_weighted"],
                                       bound=want["r2_weighted_bound"]), want["r2_weighted_bound"])
    others = max(abs(float(res["r2_raw"][i]) - want["r2"][i]) for i in range(8) if i != K2_CANCEL)
    line = (f"{n_batches / seconds:.1f} forward/s, {rows / seconds:.4g} rows/s; {log.line()}; column {K2_CANCEL}"
            f" (mean 100, std 1): " + ", ".join(f"{k} error {e:.3g} (bound {b:.3g})" for k, (e, b) in cancel.items())
            + f"; the other columns' R² within {others:.3g}")
    return {k: v.cpu().numpy().tobytes() for k, v in res.items()}, line, cancel


def spearman_bound(rp: np.ndarray, rt: np.ndarray) -> float:
    """float32 error bound of Spearman's compute over float64 ranks ``rp``, ``rt``: the means and
    the three sums of products, each within ``gamma(1, n) * Σ|term|``."""
    n = len(rp)
    g = gamma(1, n)
    pd, td = rp - rp.mean(), rt - rt.mean()
    dm_p, dm_t = g * rp.sum() / n, g * rt.sum() / n
    vp, vt, cov = np.sum(pd * pd), np.sum(td * td), np.sum(pd * td)
    d_cov = g * np.sum(np.abs(pd * td)) + n * dm_p * dm_t
    d_vp, d_vt = g * vp + n * dm_p ** 2, g * vt + n * dm_t ** 2
    return d_cov / np.sqrt(vp * vt) + abs(cov) / np.sqrt(vp * vt) * (d_vp / vp + d_vt / vt) / 2


def _tied_pairs(v: np.ndarray) -> float:
    _, c = np.unique(v, return_counts=True)
    return float(np.sum(c * (c - 1.0) / 2))


def kendall_bounds(x: np.ndarray, y: np.ndarray, variant: str, tau: float, z: float, p: float):
    """float32 error bounds of tau and of its p-value on float64 data without NaN. The int64 counts
    are rounded to float32 (half an ulp of at most n(n-1)/2 each, and their difference), the rest
    costs a few roundings; ``z = (con - dis) / sqrt(var)`` carries the counts' error into
    ``p = 2 Φ(-|z|)`` through ``2 φ(z) δz``."""
    n = len(x)
    total = n * (n - 1) / 2
    delta = 1.5 * float(np.spacing(np.float32(total)))
    if variant == "b":
        denom = np.sqrt((total - _tied_pairs(y)) * (total - _tied_pairs(x)))
    else:
        m = min(len(np.unique(x)), len(np.unique(y)))
        denom = n * n * (m - 1) / m / 2
    con_min_dis = abs(tau) * denom
    tau_bound = delta / denom + 8 * U32 * abs(tau)
    dz = abs(z) * (delta / max(con_min_dis, 1.0) + 16 * U32)
    p_bound = 2 * np.exp(-z * z / 2) / np.sqrt(2 * np.pi) * dz + 8 * U32 * p
    return tau_bound, p_bound


def path_k3_data(n_spearman: int = 1_000_000, n_kendall: int = 50_000):
    """K3's scores, float32: Spearman's 1,000,000 pairs (correlation 0.6) with 10% of the values
    in each coordinate rounded to a quarter, so tied (seed 37); Kendall's 50,000 pairs on a grid of
    0.05, so tied, and weakly correlated, so the p-value is neither 0 nor 1 (seed 41)."""
    rng = np.random.RandomState(37)
    x = rng.randn(n_spearman)
    y = 0.6 * x + 0.8 * rng.randn(n_spearman)
    for v in (x, y):
        tied = rng.rand(n_spearman) < 0.1
        v[tied] = np.round(v[tied] * 4) / 4
    rng = np.random.RandomState(41)
    kx = np.round(rng.randn(n_kendall) * 20) / 20
    ky = np.round((0.015 * kx + rng.randn(n_kendall)) * 20) / 20
    return [a.astype(np.float32) for a in (x, y, kx, ky)]


def run_path_k3(device, tier_name: str = "graph", n_spearman: int = 1_000_000, n_kendall: int = 50_000):
    """K3, rank correlations: ``SpearmanCorrCoef`` over ``n_spearman`` pairs in 100 updates and one
    compute, against ``scipy.stats.spearmanr`` within its float32 bound; ``KendallRankCorrCoef``
    (``variant="b"`` and ``"c"``, ``t_test=True``) over ``n_kendall`` tied pairs in 10 updates,
    against ``scipy.stats.kendalltau`` (tau and the asymptotic p-value) within theirs. Returns
    (values, line, the Kendall computes' wall and peak memory)."""
    from scipy.stats import kendalltau, norm, rankdata, spearmanr

    from torchmetrics_tpu_torch.regression import KendallRankCorrCoef, SpearmanCorrCoef

    x, y, kx, ky = path_k3_data(n_spearman, n_kendall)
    values, errors = {}, {}
    sx, sy = (torch.from_numpy(a).to(device) for a in (x, y))
    step = n_spearman // 100
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the buffer warning
        spearman = SpearmanCorrCoef(device=device)
    sync()
    t0 = time.perf_counter()
    for i in range(0, n_spearman, step):
        spearman.update(sx[i:i + step], sy[i:i + step])
    rho = spearman.compute()
    sync()
    spearman_s = time.perf_counter() - t0
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    want = spearmanr(x64, y64).statistic
    bound = spearman_bound(rankdata(x64), rankdata(y64))
    errors["spearman"] = (check_rel("path K3 SpearmanCorrCoef", rho, want, bound=bound), bound)
    values["spearman"] = float(rho)
    kdev = [torch.from_numpy(a).to(device) for a in (kx, ky)]
    kstep = n_kendall // 10
    costs = {}
    for variant in ("b", "c"):
        metric = KendallRankCorrCoef(variant=variant, t_test=True, device=device)
        for i in range(0, n_kendall, kstep):
            metric.update(kdev[0][i:i + kstep], kdev[1][i:i + kstep])
        if device.type == "cuda":
            sync()
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
        t0 = time.perf_counter()
        tau, pvalue = metric.compute()
        sync()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(device) - base) / 2**30 if device.type == "cuda" else float("nan")
        ref = kendalltau(kx.astype(np.float64), ky.astype(np.float64), variant=variant, method="asymptotic")
        z = float(np.sign(ref.statistic) * norm.isf(ref.pvalue / 2))
        tau_bound, p_bound = kendall_bounds(kx.astype(np.float64), ky.astype(np.float64), variant, ref.statistic, z,
                                            ref.pvalue)
        errors[f"kendall_{variant}"] = (check_rel(f"path K3 Kendall tau-{variant}", tau, ref.statistic, bound=tau_bound),
                                        tau_bound)
        errors[f"kendall_{variant}_p"] = (check_rel(f"path K3 Kendall tau-{variant} p-value", pvalue, ref.pvalue,
                                                    bound=p_bound), p_bound)
        values[f"kendall_{variant}"] = (float(tau), float(pvalue))
        costs[variant] = (wall, peak)
    line = (f"Spearman {n_spearman:,} pairs (100 updates + compute) {spearman_s * 1e3:.2f} ms, rho {values['spearman']!r};"
            f" Kendall over {n_kendall:,} pairs: " + "; ".join(
                f"tau-{v} {values[f'kendall_{v}'][0]!r}, p {values[f'kendall_{v}'][1]!r}, compute {w * 1e3:.2f} ms wall,"
                f" {pk:.3f} GiB peak device memory beyond the state" for v, (w, pk) in costs.items())
            + "; errors (bound) " + ", ".join(f"{k} {e:.3g} ({b:.3g})" for k, (e, b) in errors.items()))
    return values, line, costs


def path_k4_data(n_batches: int = 100, rows: int = 1000, dim: int = 768, classes: int = 1000, claims: int = 1_000_000):
    """K4's inputs, float32 (seed 43): sentence-embedding pairs, a teacher's and a student's softmax
    outputs over 1,000 classes (and their logs), and insurance claims (70% zero, else gamma) with
    positive predictions."""
    rng = np.random.default_rng(43)
    emb_p = rng.standard_normal((n_batches * rows, dim), dtype=np.float32)
    emb_t = emb_p + np.float32(0.5) * rng.standard_normal((n_batches * rows, dim), dtype=np.float32)
    teacher = np.float32(2) * rng.standard_normal((n_batches * rows, classes), dtype=np.float32)
    student = teacher + np.float32(0.5) * rng.standard_normal((n_batches * rows, classes), dtype=np.float32)

    def log_softmax(z):
        z = z - z.max(-1, keepdims=True)
        return z - np.log(np.exp(z).sum(-1, keepdims=True))

    log_p, log_q = log_softmax(teacher), log_softmax(student)
    claim = np.where(rng.random(claims) < 0.3, rng.gamma(2.0, 500.0, claims), 0.0).astype(np.float32)
    predicted = (300.0 * rng.lognormal(0.0, 0.5, claims)).astype(np.float32)
    return {"emb_p": emb_p, "emb_t": emb_t, "p": np.exp(log_p), "q": np.exp(log_q), "log_p": log_p, "log_q": log_q,
            "predicted": predicted, "claim": claim}


def kl_np(p: np.ndarray, q: np.ndarray, log_prob: bool):
    """Mean KL(P||Q) of float32 rows in float64, by chunks, and its float32 error bound: per row
    ``u Σ p (64 + 2 |log(p/q)|)`` (the normalisation's sums, the ratio, the log), then the mean."""
    total, bound = 0.0, 0.0
    for lo in range(0, p.shape[0], 1000):
        a, b = p[lo:lo + 1000].astype(np.float64), q[lo:lo + 1000].astype(np.float64)
        if log_prob:
            pa, ratio = np.exp(a), a - b
        else:
            pa = a / a.sum(-1, keepdims=True)
            ratio = np.log(pa) - np.log(b / b.sum(-1, keepdims=True))
        total += np.sum(pa * ratio)
        bound += U32 * np.sum(pa * (64 + 2 * np.abs(ratio)))
    return total / p.shape[0], bound / p.shape[0]


def tweedie_np(preds: np.ndarray, target: np.ndarray, power: float) -> float:
    p, t = preds.astype(np.float64), target.astype(np.float64)
    return float(np.mean(2 * (t ** (2 - power) / ((1 - power) * (2 - power)) - t * p ** (1 - power) / (1 - power)
                              + p ** (2 - power) / (2 - power))))


def run_path_k4(device, tier_name: str, data: dict):
    """K4, distribution and embedding metrics: ``CosineSimilarity(reduction="mean")`` over 100 x 1,000
    embedding pairs (768-d), ``KLDivergence()`` and ``KLDivergence(log_prob=True)`` over 100 x 1,000
    rows of 1,000-class softmax outputs, ``[TweedieDevianceScore(power=1.5), MeanSquaredLogError()]``
    over 1,000,000 claims in 100 calls: each through ``forward``, then ``compute``, against float64
    numpy; ``data`` is ``path_k4_data()``'s. Returns (values, line)."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.ops.dispatch import STATS
    from torchmetrics_tpu_torch.regression import (
        CosineSimilarity,
        KLDivergence,
        MeanSquaredLogError,
        TweedieDevianceScore,
    )

    n_batches = 100
    values, lines = {}, []
    parts = (
        ("cosine", CosineSimilarity(reduction="mean", device=device), ("emb_p", "emb_t")),
        ("kl", KLDivergence(device=device), ("p", "q")),
        ("kl_log_prob", KLDivergence(log_prob=True, device=device), ("log_p", "log_q")),
        ("claims", MetricCollection({"tweedie": TweedieDevianceScore(power=1.5, device=device),
                                     "msle": MeanSquaredLogError(device=device)}), ("predicted", "claim")),
    )
    for name, metric, keys in parts:
        dev = [torch.from_numpy(data[k]).to(device) for k in keys]
        step = dev[0].shape[0] // n_batches
        batches = [tuple(d[i:i + step] for d in dev) for i in range(0, dev[0].shape[0], step)]
        log = StepLog(f"path K4 {name}", tier_name)
        before = STATS.n_fallbacks
        _, seconds = loop(log, metric, batches)
        if tier_name == "graph" and name != "cosine" and STATS.n_fallbacks != before:  # cosine: list states, eager
            raise AssertionError(f"path K4 {name}: {STATS.n_fallbacks - before} fallbacks on the graph tier")
        result = metric.compute()
        a, b = (data[k] for k in keys)
        if name == "cosine":
            a64, b64 = a.astype(np.float64), b.astype(np.float64)
            want = {"cosine": np.mean(np.sum(a64 * b64, -1) / (np.linalg.norm(a64, axis=-1) * np.linalg.norm(b64, axis=-1)))}
            got, bounds = {"cosine": result}, {}
        elif name == "claims":
            want = {"tweedie": tweedie_np(a, b, 1.5),
                    "msle": float(np.mean((np.log1p(a.astype(np.float64)) - np.log1p(b.astype(np.float64))) ** 2))}
            got, bounds = result, {}
        else:
            kl, kl_bound = kl_np(a, b, name == "kl_log_prob")
            want, got, bounds = {name: kl}, {name: result}, {name: kl_bound}
        for key, w in want.items():
            err = check_rel(f"path K4 {key}", got[key], w, bound=bounds.get(key, 0.0))
            values[key] = float(got[key])
            lines.append(f"{key} {values[key]!r} (error {err:.3g}{f', bound {bounds[key]:.3g}' if key in bounds else ''})")
        lines.append(f"{name} {len(batches) / seconds:.1f} forward/s, {log.line()}")
        del dev, batches, metric
    return values, "; ".join(lines)


def ragged_k_data(n: int = 2000):
    """K5's inputs, ``n`` samples (seed 47), as numpy arrays: real pairs with ties, three outputs,
    strictly positive pairs, claims with zeros, Kendall's NaN, +-inf and signed zeros, probability
    rows with zeros in ``q``, their logs, and 16-d embeddings."""
    rng = np.random.RandomState(47)
    p = np.round(rng.randn(n) * 4) / 4
    t = np.round((0.7 * p + 0.6 * rng.randn(n) + 2.0) * 4) / 4
    p3 = rng.randn(n, 3) * [1.0, 3.0, 0.5] + [0.0, 10.0, -2.0]
    t3 = p3 + rng.randn(n, 3) * 0.7
    specials = np.array([1.0, np.nan, 2.0, np.inf, -np.inf, 3.0, 0.0, -0.0, -1.0, 2.0])
    kx = np.where(rng.rand(n) < 0.3, rng.choice(specials, n), np.round(rng.randn(n) * 2))
    ky = np.where(rng.rand(n) < 0.3, rng.choice(specials, n), np.round(rng.randn(n) * 2))
    logits = rng.randn(n, 5) * 2
    probs_p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs_q = np.exp(logits + rng.randn(n, 5))
    probs_q[rng.rand(n, 5) < 0.05] = 0.0  # a zero in q where p > 0: inf, as in the JAX package
    probs_q /= probs_q.sum(-1, keepdims=True)
    data = {
        "p": p, "t": t, "p3": p3, "t3": t3, "pos_p": np.abs(p) + 0.25, "pos_t": np.abs(t) + 0.25,
        "claim": np.where(rng.rand(n) < 0.4, 0.0, rng.gamma(2.0, 3.0, n)), "kx": kx, "ky": ky,
        "probs_p": probs_p, "probs_q": probs_q, "log_p": np.log(probs_p), "log_q": logits + rng.randn(n, 5) - 3.0,
        "emb_p": rng.randn(n, 16), "emb_t": rng.randn(n, 16),
    }
    return {k: v.astype(np.float32) for k, v in data.items()}


#: K5's classes: (name, constructor arguments, input arrays); all 18 classes of the slice, over
#: num_outputs, multioutput, adjusted (at and beyond n - 1 of a batch of 500), squared, reduction,
#: log_prob, every Tweedie power branch, Minkowski p, Kendall's variants with t_test and alternative
K5_CLASSES = [
    ("MeanSquaredError", {}, ("p", "t")),
    ("MeanSquaredError", {"num_outputs": 3, "squared": False}, ("p3", "t3")),
    ("MeanAbsoluteError", {}, ("p3", "t3")),
    ("MeanSquaredLogError", {}, ("pos_p", "pos_t")),
    ("MeanAbsolutePercentageError", {}, ("p", "t")),
    ("SymmetricMeanAbsolutePercentageError", {}, ("p", "t")),
    ("WeightedMeanAbsolutePercentageError", {}, ("p", "t")),
    ("CosineSimilarity", {"reduction": "none"}, ("emb_p", "emb_t")),
    ("CosineSimilarity", {}, ("emb_p", "emb_t")),
    ("KLDivergence", {}, ("probs_p", "probs_q")),
    ("KLDivergence", {"log_prob": True, "reduction": "sum"}, ("log_p", "log_q")),
    ("KLDivergence", {"reduction": "none"}, ("probs_p", "probs_q")),
    ("LogCoshError", {"num_outputs": 3}, ("p3", "t3")),
    ("MinkowskiDistance", {"p": 1.5}, ("p", "t")),
    ("TweedieDevianceScore", {"power": -1}, ("pos_p", "t")),
    ("TweedieDevianceScore", {}, ("p", "t")),
    ("TweedieDevianceScore", {"power": 1}, ("pos_p", "claim")),
    ("TweedieDevianceScore", {"power": 1.5}, ("pos_p", "claim")),
    ("TweedieDevianceScore", {"power": 2}, ("pos_p", "pos_t")),
    ("TweedieDevianceScore", {"power": 3}, ("pos_p", "pos_t")),
    ("R2Score", {}, ("p", "t")),
    ("R2Score", {"adjusted": 499}, ("p", "t")),
    ("R2Score", {"adjusted": 700}, ("p", "t")),
    ("R2Score", {"multioutput": "raw_values"}, ("p3", "t3")),
    ("R2Score", {"num_outputs": 3, "multioutput": "variance_weighted", "adjusted": 5}, ("p3", "t3")),
    ("RelativeSquaredError", {"squared": False}, ("p", "t")),
    ("ExplainedVariance", {"multioutput": "raw_values"}, ("p3", "t3")),
    ("ExplainedVariance", {"multioutput": "variance_weighted"}, ("p", "t")),
    ("PearsonCorrCoef", {}, ("p", "t")),
    ("PearsonCorrCoef", {"num_outputs": 3}, ("p3", "t3")),
    ("ConcordanceCorrCoef", {"num_outputs": 3}, ("p3", "t3")),
    ("SpearmanCorrCoef", {}, ("p", "t")),
    ("SpearmanCorrCoef", {"num_outputs": 3}, ("p3", "t3")),
    ("KendallRankCorrCoef", {"variant": "b", "t_test": True}, ("kx", "ky")),
    ("KendallRankCorrCoef", {"variant": "c", "t_test": True, "alternative": "less"}, ("p", "t")),
    ("KendallRankCorrCoef", {"variant": "a", "t_test": True, "alternative": "greater", "num_outputs": 3}, ("p3", "t3")),
]

#: K5's functional calls: all 18 entries of the slice over their options, and the edges
K5_FUNCTIONS = [
    ("mean_squared_error", ("p3", "t3"), {"num_outputs": 3}),
    ("mean_absolute_error", ("p", "t"), {}),
    ("mean_squared_log_error", ("pos_p", "pos_t"), {}),
    ("mean_absolute_percentage_error", ("p", "t"), {}),
    ("symmetric_mean_absolute_percentage_error", ("p", "t"), {}),
    ("weighted_mean_absolute_percentage_error", ("p3", "t3"), {}),
    ("cosine_similarity", ("emb_p", "emb_t"), {"reduction": "mean"}),
    ("kl_divergence", ("probs_p", "probs_q"), {"reduction": "none"}),
    ("kl_divergence", ("log_p", "log_q"), {"log_prob": True}),
    ("log_cosh_error", ("p3", "t3"), {}),
    *[("minkowski_distance", ("p", "t"), {"p": p}) for p in (1, 2, 3)],
    *[("tweedie_deviance_score", keys, {"power": power}) for power, keys in (
        (-1, ("pos_p", "t")), (0, ("p", "t")), (1, ("pos_p", "claim")), (1.5, ("pos_p", "claim")), (2, ("pos_p", "pos_t")),
        (3, ("pos_p", "pos_t")))],
    ("r2_score", ("p3", "t3"), {"multioutput": "raw_values"}),
    ("r2_score", ("p", "t"), {"adjusted": 10}),
    ("relative_squared_error", ("p3", "t3"), {"squared": False}),
    ("explained_variance", ("p3", "t3"), {"multioutput": "variance_weighted"}),
    ("pearson_corrcoef", ("p3", "t3"), {}),
    ("concordance_corrcoef", ("p", "t"), {}),
    ("spearman_corrcoef", ("p3", "t3"), {}),
    *[("kendall_rank_corrcoef", ("kx", "ky"), {"variant": v, "t_test": True, "alternative": a})
      for v, a in (("a", "two-sided"), ("b", "less"), ("c", "greater"))],
    ("kendall_rank_corrcoef", ("p3", "t3"), {"variant": "b"}),
]


def run_path_k_ragged(device, tier_name: str = "graph", n: int = 2000):
    """K5: every class of the slice through ``forward`` over four batches of ``n / 4`` and ``compute``,
    one sample through ``R2Score`` (the JAX module's 0.0), and every functional entry, on the card
    and on the CPU (the CPU tests hold the CPU to the JAX package): within 1e-5, NaN and inf where
    the CPU has them. On the graph tier the only fallbacks are the eager forwards of the list
    states and the ``full_state_update`` metrics. Returns the card's values."""
    from torchmetrics_tpu_torch import functional as f
    from torchmetrics_tpu_torch import regression as r
    from torchmetrics_tpu_torch.ops.dispatch import STATS

    data = ragged_k_data(n)
    step = n // 4
    values = {}
    allowed = {("forward", "not_fusable"), ("update", "fast_update_class_off")}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # Spearman's buffer warning
        for i, (name, kwargs, keys) in enumerate(K5_CLASSES):
            label = f"K5 {name}#{i}"
            on_card, on_cpu = getattr(r, name)(device=device, **kwargs), getattr(r, name)(device="cpu", **kwargs)
            batches = [[torch.from_numpy(data[k][lo:lo + step]) for k in keys] for lo in range(0, n, step)]
            want = [on_cpu(*batch) for batch in batches]
            before = dict(STATS.fallbacks)
            for lo, batch, w in zip(range(0, n, step), batches, want):
                values[f"{label} batch {lo}"] = _agree(label, on_card(*[b.to(device) for b in batch]), w)
            computed = on_card.compute()
            values[label] = _agree(label, computed, on_cpu.compute())
            if name == "KLDivergence" and not kwargs and not torch.isinf(computed):
                raise AssertionError(f"path {label}: {float(computed)}; a zero in q where p > 0 gives inf in the JAX package")
            new = {k[1:] for k, v in STATS.fallbacks.items() if v != before.get(k, 0)}
            if tier_name == "graph" and not new <= allowed:
                raise AssertionError(f"path {label}: fallbacks {new} on the graph tier")
        one = [torch.tensor([1.5]), torch.tensor([2.0])]
        r2_one = r.R2Score(device=device)(*[a.to(device) for a in one])
        if float(r2_one) != 0.0:
            raise AssertionError(f"path K5 R2Score of one sample: {float(r2_one)}, the JAX module gives 0.0")
        values["R2Score one sample"] = float(r2_one)
        for name, keys, kwargs in K5_FUNCTIONS:
            args = [torch.from_numpy(data[k]) for k in keys]
            label = f"K5 {name} {kwargs}"
            values[label] = _agree(label, getattr(f, name)(*[a.to(device) for a in args], **kwargs),
                                   getattr(f, name)(*args, **kwargs))
    return values


# ---------------------------------------------------------------------------------------------
# Path L: distributed state sync (``parallel/sync.py``) and the wrappers, on the card
L_TOL = 1e-6
L_PEARSON_TOL = 1e-5
#: the full-width shares of path L2, by the paths they come from; tests pass smaller ones
L2_SIZES = {"a_rows": 1_000_000, "a_batch": 10_000, "b_rows": 50_000, "b_batch": 1_000, "b_classes": 1000,
            "c_rows": 1_000_000, "c_batch": 10_000, "d_batch": 65_536, "d_batches": 16, "h_docs": 1 << 20,
            "h_split": 600_000, "h_queries": 10_000, "p_rows": 1_000_000, "p_split": 370_000, "p_batch": 10_000,
            "k4_rows": 100_000, "k4_batch": 1_000, "k4_dim": 768, "idle_rows": 10_000}
#: seconds the parent waits for the two workers of path L2 before it kills them and fails
L2_LIMIT_S = 420


def kernel_counters() -> dict:
    """Every kernel's launch counter, by a name that does not depend on the order of imports."""
    from torchmetrics_tpu_torch.ops import bincount as k1
    from torchmetrics_tpu_torch.ops import curve_counts as k3
    from torchmetrics_tpu_torch.ops import hist_pair as k2

    return {"K1": k1.BINCOUNT, "K3 binned_confmat": k3.BINNED_CONFMAT, "K3 direct": k3.CURVE_COUNTS,
            "K2 hist_pair": k2.HIST_PAIR, "K2 sketch_update": k2.SKETCH_UPDATE}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _bits(value):
    """A value's bits on the host: tensors as bytes (NaN-exact), dicts and sequences item by item."""
    if isinstance(value, dict):
        return {k: _bits(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_bits(v) for v in value]
    if isinstance(value, torch.Tensor):
        return (str(value.dtype), tuple(value.shape), value.detach().cpu().numpy().tobytes())
    return value


def _members(m):
    from torchmetrics_tpu_torch import MetricCollection

    return list(m._modules.values()) if isinstance(m, MetricCollection) else [m]


def _fresh_compute(m):
    """``m.compute()`` again over the same state: the cached values dropped first."""
    for member in _members(m):
        member._computed = None
    return m.compute()


def sync_report(m, computes: int = 2) -> dict:
    """The wall of ``computes`` computes of ``m`` (the state synced in each, after one untimed
    compute that also captures what the graph tier captures), with the gathers of one compute: how
    many, their wall on this rank, and the bytes this rank received."""
    _fresh_compute(m)
    walls = []
    for _ in range(computes):
        sync()
        t0 = time.perf_counter()
        _fresh_compute(m)
        sync()
        walls.append(time.perf_counter() - t0)
    gathers = sum(len(mm._tm_last_sync["gather_latency_us"]) for mm in _members(m))
    gather_us = sum(sum(mm._tm_last_sync["gather_latency_us"].values()) for mm in _members(m))
    received = sum(mm._tm_last_sync["bytes_received"] for mm in _members(m))
    return {"compute_ms": float(np.median(walls)) * 1e3, "gathers": gathers, "gather_ms": gather_us / 1e3,
            "bytes": received}


def _l2_cases(device, sizes: dict):
    """Path L2's metrics and their data on ``device``: ``{name: (make, call, batches, shares, check)}``.
    ``make(**kw)`` builds the metric, ``call`` is ``"forward"``, ``"update"`` or ``"retrieval"`` (an
    update with ``indexes``), ``batches`` the whole data as argument tuples, ``shares[r]`` rank ``r``'s
    indices into them, ``check`` how rank 0's synced value is held to the single-process compute over
    the whole data (``bits``, or a relative tolerance). The big arrays are made on the card from a seeded generator, the same on every rank."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.aggregation import CatMetric
    from torchmetrics_tpu_torch.classification import (
        BinaryAUROC,
        BinaryAveragePrecision,
        MulticlassConfusionMatrix,
    )
    from torchmetrics_tpu_torch.regression import CosineSimilarity, MeanSquaredError, PearsonCorrCoef
    from torchmetrics_tpu_torch.retrieval import RetrievalMAP

    s = sizes

    def halves(n):
        return [*range(n // 2)], [*range(n // 2, n)]

    cases = {}
    # path A: the four-metric collection, 100 x 10,000 labels (seed 0), K1
    rng = np.random.RandomState(0)
    pa = torch.from_numpy(rng.randint(0, 5, s["a_rows"]).astype(np.int32)).to(device)
    ta = torch.from_numpy(rng.randint(0, 5, s["a_rows"]).astype(np.int32)).to(device)
    nb = s["a_rows"] // s["a_batch"]
    batches = [(pa[i * s["a_batch"]:(i + 1) * s["a_batch"]], ta[i * s["a_batch"]:(i + 1) * s["a_batch"]]) for i in range(nb)]
    cases["A collection"] = (lambda **kw: collection(5, device=device, **kw), "forward", batches, halves(nb), "bits")
    # path B: C = 1000 logits, ignore_index=-1 on 1%: the collection and the 1000 x 1000 confusion matrix (K1)
    gen = torch.Generator(device).manual_seed(0)
    c = s["b_classes"]
    logits = torch.randn(s["b_rows"], c, device=device, generator=gen)
    target = torch.randint(0, c, (s["b_rows"],), device=device, generator=gen)
    target[torch.rand(s["b_rows"], device=device, generator=gen) < 0.01] = -1
    nb = s["b_rows"] // s["b_batch"]
    batches = [(logits[i * s["b_batch"]:(i + 1) * s["b_batch"]], target[i * s["b_batch"]:(i + 1) * s["b_batch"]])
               for i in range(nb)]
    cases["B collection"] = (lambda **kw: collection(c, ignore_index=-1, device=device, **kw), "forward", batches,
                             halves(nb), "bits")
    cases["B confusion matrix"] = (lambda **kw: MulticlassConfusionMatrix(c, ignore_index=-1, device=device, **kw),
                                   "update", batches, halves(nb), "bits")
    # path C: binned AUROC + AP at 200 thresholds (K3); path D: the sketched AUROC (K2's sketch_update)
    rng = np.random.RandomState(5)
    cp = torch.from_numpy(rng.rand(s["c_rows"]).astype(np.float32)).to(device)
    ct = torch.from_numpy(rng.randint(0, 2, size=s["c_rows"]).astype(np.int32)).to(device)
    nb = s["c_rows"] // s["c_batch"]
    batches = [(cp[i * s["c_batch"]:(i + 1) * s["c_batch"]], ct[i * s["c_batch"]:(i + 1) * s["c_batch"]]) for i in range(nb)]
    cases["C binned AUROC + AP"] = (
        lambda **kw: MetricCollection([BinaryAUROC(thresholds=200, device=device, **kw),
                                       BinaryAveragePrecision(thresholds=200, device=device, **kw)]),
        "forward", batches, halves(nb), "bits")
    rng = np.random.RandomState(17)
    dp = rng.uniform(0.0, 1.0, (s["d_batches"], s["d_batch"])).astype(np.float32)
    dt = (rng.uniform(0, 1, dp.shape) < np.clip(dp * 0.8 + 0.1, 0, 1)).astype(np.int32)
    batches = [(torch.from_numpy(dp[i]).to(device), torch.from_numpy(dt[i]).to(device)) for i in range(s["d_batches"])]

    def sketch(**kw):
        m = BinaryAUROC(approx="sketch", sketch_bins=2048, device=device, **kw)
        m.fast_update = True  # path D's update-only graph tier
        return m

    cases["D sketched AUROC"] = (sketch, "update", batches, halves(s["d_batches"]), "bits")
    # path H: MAP over 2^20 documents, split 600,000 and 448,576 (cat states, int32 ids)
    rng = np.random.RandomState(9)
    hp = torch.from_numpy(rng.rand(s["h_docs"]).astype(np.float32)).to(device)
    ht = torch.from_numpy(rng.randint(0, 2, size=s["h_docs"]).astype(np.int32)).to(device)
    hi = torch.from_numpy(np.sort(rng.randint(0, s["h_queries"], size=s["h_docs"])).astype(np.int32)).to(device)
    cut = s["h_split"]
    batches = [(hp[:cut], ht[:cut], hi[:cut]), (hp[cut:], ht[cut:], hi[cut:])]
    cases["H MAP"] = (lambda **kw: RetrievalMAP(device=device, **kw), "retrieval", batches, ([0], [1]), "bits")
    # K1's pairs: Pearson split 370,000 and 630,000 (None reduction), MSE (float sums)
    preds, target = (torch.from_numpy(a.reshape(-1)[:s["p_rows"]]).to(device) for a in path_k_data("K1"))
    nb = s["p_rows"] // s["p_batch"]
    batches = [(preds[i * s["p_batch"]:(i + 1) * s["p_batch"]], target[i * s["p_batch"]:(i + 1) * s["p_batch"]])
               for i in range(nb)]
    split = s["p_split"] // s["p_batch"]
    cases["K1 Pearson"] = (lambda **kw: PearsonCorrCoef(device=device, **kw), "update", batches,
                           ([*range(split)], [*range(split, nb)]), L_PEARSON_TOL)
    cases["K1 MSE"] = (lambda **kw: MeanSquaredError(device=device, **kw), "update", batches,
                       ([*range(split)], [*range(split, nb)]), L_TOL)
    # K4's cosine similarity: 100 x 1,000 x 768 embedding pairs in cat states
    gen = torch.Generator(device).manual_seed(43)
    emb_p = torch.randn(s["k4_rows"], s["k4_dim"], device=device, generator=gen)
    emb_t = emb_p + 0.5 * torch.randn(s["k4_rows"], s["k4_dim"], device=device, generator=gen)
    nb = s["k4_rows"] // s["k4_batch"]
    batches = [(emb_p[i * s["k4_batch"]:(i + 1) * s["k4_batch"]], emb_t[i * s["k4_batch"]:(i + 1) * s["k4_batch"]])
               for i in range(nb)]
    cases["K4 cosine"] = (lambda **kw: CosineSimilarity(reduction="mean", device=device, **kw), "update", batches,
                          halves(nb), "bits")
    # a CatMetric whose rank 1 is idle
    values = torch.from_numpy(np.random.RandomState(1).randn(s["idle_rows"]).astype(np.float32)).to(device)
    cases["idle rank CatMetric"] = (lambda **kw: CatMetric(device=device, **kw), "update",
                                    [(values[i::10],) for i in range(10)], ([*range(10)], []), "bits")
    return cases


def _feed(m, call: str, batches) -> None:
    for b in batches:
        if call == "retrieval":
            m.update(b[0], b[1], indexes=b[2])
        elif call == "forward":
            m(*b)
        else:
            m.update(*b)


def l2_worker(rank: int, address: str, out_path: str, sizes: dict, device_name: str) -> int:
    """One rank of path L2 (``chip_smoke.py --sync-worker``): joins a gloo world of two on
    ``device_name``, updates its share of each case, computes with the states synced (timed),
    then, on rank 0, holds the synced value to the single-process compute over the whole data and
    the synced states to its states (counts exact, ``cat`` states bit-equal). Writes its values,
    timings and kernel launches to ``out_path``."""
    import warnings
    from datetime import timedelta

    import torch.distributed as dist

    device = torch.device(device_name)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://{address}", rank=rank, world_size=2,
                            timeout=timedelta(seconds=120))
    warnings.simplefilter("ignore")  # an idle rank computes before its own update
    try:
        cases = _l2_cases(device, sizes)
        counters = kernel_counters()
        for counter in counters.values():
            counter.launches = 0
        metrics, values, reports = {}, {}, {}
        for name, (make, call, batches, shares, _) in cases.items():
            m = metrics[name] = make()
            _feed(m, call, [batches[i] for i in shares[rank]])
            values[name] = _cpu(m.compute())
            reports[name] = sync_report(m)
        sync()
        launches = {name: c.launches for name, c in counters.items()}
        checks = {}
        for name, (make, call, batches, shares, check) in cases.items():
            m = metrics[name]
            if rank == 0:  # the single-process compute over the whole data, no collective
                ref = make(sync_on_compute=False)
                _feed(ref, call, batches)
                checks[name] = _check_l2(name, values[name], _cpu(ref.compute()), check)
            for i, member in enumerate(_members(m)):  # the synced states against one process's (every rank joins)
                member.sync()
                if rank == 0:
                    checks[name] += "; " + _check_state(name, member, _members(ref)[i], check)
                member.unsync()
    finally:
        dist.destroy_process_group()
    torch.save({"rank": rank, "values": values, "reports": reports, "launches": launches, "checks": checks}, out_path)
    return 0


def _cpu(value):
    """A computed value on the host, for the file the parent reads."""
    if isinstance(value, dict):
        return {k: _cpu(v) for k, v in value.items()}
    return value.detach().cpu() if isinstance(value, torch.Tensor) else value


def _check_l2(name: str, got, want, check) -> str:
    if check == "bits":
        if _bits(got) != _bits(want):
            raise AssertionError(f"path L2 {name}: the synced value {got} is not the single-process value {want}, bit for bit")
        return "value bit-equal to one process over the whole data"
    got_f, want_f = float(got), float(want)
    err = abs(got_f - want_f) / max(abs(want_f), 1e-30)
    if not np.isfinite(got_f) or err > check:
        raise AssertionError(f"path L2 {name}: synced {got_f!r}, one process {want_f!r} (relative error {err:.3g} > {check})")
    return f"value within {err:.3g} relative of one process over the whole data (tolerance {check})"


def _check_state(name: str, member, ref, check) -> str:
    """Rank 0's synced state against the single-process state: integer states exactly, ``cat``
    states bit for bit, float sums within the tolerance; Pearson's ``None`` states carry a world axis
    and are held through the value only."""
    got, want = member._computable_state(), ref._computable_state()
    worst, compared = 0.0, 0
    for key, g in got.items():
        w = want[key]
        if member._reductions[key] is None and not isinstance(g, list) and g.shape != w.shape:
            continue  # the stacked world axis; the value check above holds it
        compared += 1
        if isinstance(g, list) or isinstance(w, list):
            if not (g == [] and w == []):
                raise AssertionError(f"path L2 {name}.{key}: an empty state on one side only")
            continue
        if not g.is_floating_point() or check == "bits":
            if _bits(g) != _bits(w):
                raise AssertionError(f"path L2 {name}.{key}: the synced state differs from one process's")
        else:
            worst = max(worst, float(((g.double() - w.double()).abs() / w.double().abs().clamp_min(1e-30)).max()))
            if worst > check:
                raise AssertionError(f"path L2 {name}.{key}: synced state off by {worst:.3g} relative")
    if not compared:
        return "states stacked along the world axis, held through the value"
    return "states exact" if worst == 0.0 else f"float states within {worst:.3g} relative"


def run_path_l2(device, sizes: dict = L2_SIZES, workers: int = 2):
    """Path L2: ``chip_smoke.py`` runs itself twice with ``--sync-worker``, two ranks of one gloo
    world on ``device`` (``cuda:0`` on the card: NCCL cannot hold two ranks on one card). Returns
    ({case: (rank 0's value bits, per-rank timings, rank 0's checks)}, the kernel launches of both
    ranks' sharded updates and synced computes by counter)."""
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "path_l2")
    os.makedirs(out_dir, exist_ok=True)
    address = f"127.0.0.1:{free_port()}"
    paths = [os.path.join(out_dir, f"rank{r}.pt") for r in range(workers)]
    for p in paths:
        if os.path.exists(p):
            os.remove(p)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sync-worker", str(r), address, paths[r],
                               json.dumps(sizes), str(device)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(workers)]
    deadline = time.perf_counter() + L2_LIMIT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.perf_counter())))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"path L2: the two ranks did not end within {L2_LIMIT_S} s; both killed")
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"path L2: rank {r} failed (exit {p.returncode}):\n{out[-3000:]}\n{err[-6000:]}")
    results = [torch.load(p, weights_only=True) for p in paths]
    cases = {}
    for name, value in results[0]["values"].items():
        bits = _bits(value)
        if _bits(results[1]["values"][name]) != bits:
            raise AssertionError(f"path L2 {name}: the two ranks hold different bits")
        cases[name] = (bits, [r["reports"][name] for r in results], results[0]["checks"][name])
    launches = {name: sum(r["launches"][name] for r in results) for name in results[0]["launches"]}
    return cases, launches


def run_path_l1(device, data_a, data_h, batch_a: int = 10_000, backend: str = "nccl"):
    """Path L1: a one-rank NCCL world in this process (a TCP store on a free local port). Path A's
    collection (100 ``forward`` calls) and path H's MAP, built with ``distributed_available_fn`` so
    that they sync at world 1, must give the bits of the same computes with no process group; the
    profiler counts what NCCL runs on the card for one compute of each. Returns (line, K1 launches
    of the synced forwards)."""
    import torch.distributed as dist

    from torchmetrics_tpu_torch.ops.bincount import BINCOUNT
    from torchmetrics_tpu_torch.retrieval import RetrievalMAP

    pa, ta = data_a
    hp, ht, hi = data_h
    n_batches = ta.shape[0] // batch_a
    batches = [(pa[i * batch_a:(i + 1) * batch_a], ta[i * batch_a:(i + 1) * batch_a]) for i in range(n_batches)]
    plain, plain_map = collection(5, device=device), RetrievalMAP(device=device)
    _feed(plain, "forward", batches)
    plain_map.update(hp, ht, indexes=hi)
    want = _bits((plain.compute(), plain_map.compute()))
    extra = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1, **extra)
    try:
        always = {"distributed_available_fn": lambda: True}
        synced, synced_map = collection(5, device=device, **always), RetrievalMAP(device=device, **always)
        sync()
        BINCOUNT.launches = 0
        _feed(synced, "forward", batches)
        synced_map.update(hp, ht, indexes=hi)
        got = _bits((synced.compute(), synced_map.compute()))
        sync()
        launches = BINCOUNT.launches
        if got != want:
            raise AssertionError("path L1: the computes synced through the one-rank NCCL world differ from the same"
                                 " computes with no process group")
        reports = {"A collection": sync_report(synced), "H MAP": sync_report(synced_map)}
        nccl = {}
        if backend == "nccl":
            activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            for name, m in (("A collection", synced), ("H MAP", synced_map)):
                with torch.profiler.profile(activities=activities) as prof:
                    _fresh_compute(m)
                    sync()
                ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
                coll = [e for e in ops if "nccl" in e.name.lower()]
                copies = [e for e in ops if "DtoD" in e.name]
                if not coll:
                    raise AssertionError(f"path L1 {name}: the profiler shows no NCCL operation on the card")
                nccl[name] = (len(coll), sum(e.time_range.end - e.time_range.start for e in coll),
                              len(copies), sum(e.time_range.end - e.time_range.start for e in copies),
                              sorted({e.name for e in coll}))
    finally:
        dist.destroy_process_group()
    parts = []
    for name, r in reports.items():
        text = (f"{name}: bit-equal to no group; sync + compute {r['compute_ms']:.4f} ms, {r['gathers']} gathers"
                f" ({r['gather_ms']:.4f} ms), {r['bytes']} bytes")
        if name in nccl:
            n, us, nc, cus, names = nccl[name]
            text += (f"; on the card per compute: {n} NCCL operations {names} ({us:.2f} us of device time),"
                     f" {nc} device-to-device copies ({cus:.2f} us)")
        parts.append(text)
    return "; ".join(parts), launches


def run_path_l3(device, tier_name: str, data: dict, cpu_boot=None):
    """Path L3: the six wrappers at full width on one tier. Each is held to float64 numpy, or, for
    ``BootStrapper``, to the port's CPU run under the same seed. Returns (values for the tier
    comparison, {wrapper: line}, K1 launches, the CPU run's BootStrapper value)."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import BinaryAccuracy, MulticlassAccuracy, MulticlassF1Score
    from torchmetrics_tpu_torch.ops.bincount import BINCOUNT
    from torchmetrics_tpu_torch.regression import MeanSquaredError, R2Score
    from torchmetrics_tpu_torch.wrappers import (
        BootStrapper,
        ClasswiseWrapper,
        MetricTracker,
        MinMaxMetric,
        MultioutputWrapper,
        MultitaskWrapper,
    )

    values, lines = {}, {}
    batch_a = data["batch_a"]
    pa, ta = data["a"]
    a_batches = [(pa[i * batch_a:(i + 1) * batch_a], ta[i * batch_a:(i + 1) * batch_a]) for i in range(ta.shape[0] // batch_a)]
    sync()
    BINCOUNT.launches = 0
    # BootStrapper over path A, held to the CPU run under the same seed
    boot = BootStrapper(MulticlassAccuracy(num_classes=5, device=device), num_bootstraps=10, seed=0, raw=True)
    log = StepLog("path L3 BootStrapper", tier_name)
    loop(log, boot.update, a_batches)
    got = boot.compute()
    if cpu_boot is None:
        cpu = BootStrapper(MulticlassAccuracy(num_classes=5, device="cpu"), num_bootstraps=10, seed=0, raw=True)
        for p, t in a_batches:
            cpu.update(p.cpu(), t.cpu())
        cpu_boot = {k: v.double().numpy() for k, v in cpu.compute().items()}
    raw = cpu_boot["raw"]
    for i, w in enumerate(raw):  # each copy's accuracy, from the same resample's exact counts
        check_rel(f"path L3 BootStrapper copy {i}", got["raw"][i], w, tol=L_TOL)
    check_rel("path L3 BootStrapper mean", got["mean"], float(cpu_boot["mean"]), tol=L_TOL)
    # the std of ten nearly equal values: float32 rounding of the mean, n + 4 ulps of the values, in absolute terms
    std_bound = (len(raw) + 4) * U32 * float(np.abs(raw).max())
    std_err = check_rel("path L3 BootStrapper std", got["std"], float(cpu_boot["std"]), tol=L_TOL, bound=std_bound)
    values["BootStrapper"] = _bits(got)
    lines["BootStrapper"] = (f"10 copies of MulticlassAccuracy(5), {len(a_batches)} x {batch_a:,} labels: {log.line()};"
                             f" mean {float(got['mean']):.7f}, std {float(got['std']):.7g}; each copy and the mean within {L_TOL}"
                             f" of the CPU run's, the std within {std_err:.3g} (bound {std_bound:.3g})")
    # ClasswiseWrapper of the per-class F1 at C = 1000 over path B's logits
    lb, tb, batch_b = data["b"]
    b_batches = [(lb[i * batch_b:(i + 1) * batch_b], tb[i * batch_b:(i + 1) * batch_b]) for i in range(tb.shape[0] // batch_b)]
    c = lb.shape[1]
    cw = ClasswiseWrapper(MulticlassF1Score(num_classes=c, average=None, ignore_index=-1, device=device))
    log = StepLog("path L3 ClasswiseWrapper", tier_name)
    loop(log, cw, b_batches)
    got = cw.compute()
    counts, _ = reference_values(data["b_argmax"], data["b_target"], c, ignore_index=-1)
    tp, fp, fn = counts["tp"], counts["fp"], counts["fn"]
    want = np.divide(2 * tp, 2 * tp + fp + fn, out=np.zeros_like(tp), where=(2 * tp + fp + fn) > 0)
    worst = max(abs(float(got[f"multiclassf1score_{i}"]) - want[i]) for i in range(c))
    if len(got) != c or worst > L_TOL:
        raise AssertionError(f"path L3 ClasswiseWrapper: {len(got)} classes, worst error {worst}")
    values["ClasswiseWrapper"] = _bits(got)
    lines["ClasswiseWrapper"] = (f"MulticlassF1Score({c}, average=None) over path B, {len(b_batches)} x {batch_b:,} rows:"
                                 f" {log.line()}; {c} classes within {worst:.3g}")
    # MultioutputWrapper of R2Score over K2's 8 outputs, with the float32 bound of the moment sums
    kp, kt = data["k2"]
    mo = MultioutputWrapper(R2Score(device=device), 8)
    log = StepLog("path L3 MultioutputWrapper", tier_name)
    loop(log, mo, [(kp[i], kt[i]) for i in range(kp.shape[0])])
    got = mo.compute()
    want = data["k2_moments"]
    errs = [check_rel(f"path L3 MultioutputWrapper R2[{i}]", got[i], want["r2"][i], bound=want["r2_bound"][i])
            for i in range(8)]
    values["MultioutputWrapper"] = _bits(got)
    lines["MultioutputWrapper"] = (f"R2Score over 8 outputs, {kp.shape[0]} x {kp.shape[1]:,} rows: {log.line()};"
                                   f" column {K2_CANCEL} within {errs[K2_CANCEL]:.3g} (bound {want['r2_bound'][K2_CANCEL]:.3g}),"
                                   f" the others within {max(e for i, e in enumerate(errs) if i != K2_CANCEL):.3g}")
    # MetricTracker over 5 epochs of path A's collection: epoch e predicts 20 e % of the labels right
    tracker = MetricTracker(collection(5, device=device), maximize=[True, True, True, True])
    log = StepLog("path L3 MetricTracker", tier_name)
    rows = torch.arange(ta.shape[0], device=ta.device)
    want_epochs = []
    for e in range(5):
        pe = torch.where(rows % 5 < e, ta, pa)
        tracker.increment()
        loop(log, tracker, [(pe[i * batch_a:(i + 1) * batch_a], ta[i * batch_a:(i + 1) * batch_a])
                            for i in range(ta.shape[0] // batch_a)])
        want_epochs.append(reference_values(pe.cpu().numpy(), data["a_target_np"], 5)[1])
    got = tracker.compute_all()
    for key in got:
        for e in range(5):
            check_rel(f"path L3 MetricTracker {key} epoch {e}", got[key][e], want_epochs[e][key], tol=L_TOL)
    best, step = tracker.best_metric(return_step=True)
    if set(step.values()) != {4}:
        raise AssertionError(f"path L3 MetricTracker: best steps {step}, expected the last epoch")
    values["MetricTracker"] = _bits(got)
    lines["MetricTracker"] = (f"path A's collection, 5 epochs of {len(a_batches)} x {batch_a:,}: {log.line()}; best step {step['MulticlassAccuracy']},"
                              f" accuracy {best['MulticlassAccuracy']:.7f}")
    # MultitaskWrapper of path A's collection and K1's MSE
    k1p, k1t = data["k1"]
    mt = MultitaskWrapper({"cls": collection(5, device=device), "reg": MeanSquaredError(device=device)})
    log = StepLog("path L3 MultitaskWrapper", tier_name)
    loop(log, mt, [({"cls": a[0], "reg": k1p[i]}, {"cls": a[1], "reg": k1t[i]}) for i, a in enumerate(a_batches)])
    got = mt.compute()
    want_a = reference_values(data["a_preds_np"], data["a_target_np"], 5)[1]
    for key, w in want_a.items():
        check_rel(f"path L3 MultitaskWrapper cls {key}", got["cls"][key], w, tol=L_TOL)
    check_rel("path L3 MultitaskWrapper reg", got["reg"], data["k1_mse"])
    values["MultitaskWrapper"] = _bits(got)
    lines["MultitaskWrapper"] = f"path A's collection + K1's MSE, {len(a_batches)} steps: {log.line()}"
    # MinMaxMetric of BinaryAccuracy over path C's scores
    cp, ct, batch_c = data["c"]
    mm = MinMaxMetric(BinaryAccuracy(device=device))
    log = StepLog("path L3 MinMaxMetric", tier_name)
    loop(log, mm, [(cp[i * batch_c:(i + 1) * batch_c], ct[i * batch_c:(i + 1) * batch_c]) for i in range(ct.shape[0] // batch_c)])
    got = mm.compute()
    running = data["c_running_accuracy"]
    check_rel("path L3 MinMaxMetric min", got["min"], running.min(), tol=L_TOL)
    check_rel("path L3 MinMaxMetric max", got["max"], running.max(), tol=L_TOL)
    values["MinMaxMetric"] = _bits(got)
    lines["MinMaxMetric"] = (f"BinaryAccuracy over path C's {ct.shape[0] // batch_c} x {batch_c:,} scores: {log.line()};"
                             f" min {float(got['min']):.7f},"
                             f" max {float(got['max']):.7f} of the running accuracy")
    sync()
    return values, lines, BINCOUNT.launches, cpu_boot


def path_l3_data(device, logits_b: np.ndarray, target_b: np.ndarray, lb, tb, batch_b: int = 1_000,
                 rows: int = 1_000_000, batch: int = 10_000):
    """Path L3's inputs on ``device`` (paths A, C, K1 and K2 at ``rows`` in batches of ``batch``; path
    B's logits as given) and the float64 numpy references they are held to."""
    rng = np.random.RandomState(0)
    a_preds = rng.randint(0, 5, rows).astype(np.int32)
    a_target = rng.randint(0, 5, rows).astype(np.int32)
    kp, kt = path_k_data("K2", rows, batch)
    k1p, k1t = path_k_data("K1", rows, batch)
    rng = np.random.RandomState(5)
    cp = rng.rand(rows).astype(np.float32)
    ct = rng.randint(0, 2, size=rows).astype(np.int32)
    n_batches = rows // batch
    correct = ((cp > 0.5).astype(np.int32) == ct).reshape(n_batches, -1).sum(1)
    running = np.cumsum(correct) / (np.arange(1, n_batches + 1) * batch)
    d = (k1p.astype(np.float64) - k1t.astype(np.float64)).ravel()
    dev = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    return {
        "batch_a": batch, "a": (dev(a_preds), dev(a_target)), "a_preds_np": a_preds, "a_target_np": a_target,
        "b": (lb, tb, batch_b), "b_argmax": logits_b.argmax(axis=1), "b_target": target_b,
        "k2": (dev(kp), dev(kt)), "k2_moments": moments_np(kp.reshape(-1, 8), kt.reshape(-1, 8), kp.shape[0], kp.shape[1]),
        "k1": (dev(k1p), dev(k1t)), "k1_mse": float(np.mean(d * d)),
        "c": (dev(cp), dev(ct), batch), "c_running_accuracy": running,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 1
    from torchmetrics_tpu_torch.ops import _build
    from torchmetrics_tpu_torch.ops import bincount as k1
    from torchmetrics_tpu_torch.ops import curve_counts as k3
    from torchmetrics_tpu_torch.ops import hist_pair as k2

    started = time.perf_counter()
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

    # ---- path A: the benchmark headline, on the graph tier and then on the eager tier
    num_a, batch_a = 5, 10_000
    rng = np.random.RandomState(0)
    preds_a = rng.randint(0, num_a, 1_000_000).astype(np.int32)
    target_a = rng.randint(0, num_a, 1_000_000).astype(np.int32)
    pa, ta = torch.from_numpy(preds_a).to(device), torch.from_numpy(target_a).to(device)
    window_a = [(pa[i * batch_a:(i + 1) * batch_a], ta[i * batch_a:(i + 1) * batch_a]) for i in range(10)]
    res_a = {}
    for tier_name in ("graph", "eager"):
        with tier(tier_name):
            mc_a = collection(num_a, validate_args=False)
            vals_a, sec_a, launches, log = run_path("path A", mc_a, k1, pa, ta, batch_a, tier_name)
            log.check(eager_first=4)
            res_a[tier_name] = check_path("path A", mc_a, preds_a, target_a, num_a,
                                          (vals_a, preds_a[-batch_a:], target_a[-batch_a:]))
            print(f"path A [{card}]: C={num_a}, 100 x {batch_a} int32 labels: {100 / sec_a:.1f} forward/s,"
                  f" {1_000_000 / sec_a:.4g} samples/s, K1 launches {launches}, branch {k1.branch(num_a**2, device)};"
                  f" {log.line()}, {device_ops_per_step(mc_a, window_a):.1f} device operations/step;"
                  f" values {res_a[tier_name]}")
            if tier_name == "graph":
                launches_a = launches
    same_on_both_tiers("path A", res_a["graph"], res_a["eager"])

    # ---- path B: ImageNet-validation-shaped logits
    num_b, batch_b, n_b = 1000, 1000, 50_000
    rng = np.random.RandomState(0)
    logits_b = rng.standard_normal((n_b, num_b)).astype(np.float32)
    target_b = rng.randint(0, num_b, n_b).astype(np.int64)
    target_b[rng.rand(n_b) < 0.01] = -1
    lb, tb = torch.from_numpy(logits_b).to(device), torch.from_numpy(target_b).to(device)
    mc_b = collection(num_b, ignore_index=-1)
    vals_b, sec_b, launches_b, log_b = run_path("path B", mc_b, k1, lb, tb, batch_b)
    preds_b = logits_b.argmax(axis=1)
    res_b = check_path("path B", mc_b, preds_b, target_b, num_b,
                       (vals_b, preds_b[-batch_b:], target_b[-batch_b:]), ignore_index=-1)
    if k1.branch(num_b**2, device) != "global":
        raise AssertionError("path B's 1M-bin count was expected on the global-memory branch")
    print(f"path B [{card}]: C={num_b}, 50 x {batch_b} f32 logit rows, ignore_index=-1 on 1%:"
          f" {50 / sec_b:.1f} forward/s, {n_b / sec_b:.4g} samples/s, K1 launches {launches_b},"
          f" branch {k1.branch(num_b**2, device)}; {log_b.line()}; values {res_b}")

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
        # the profiler has been seen to drop a window's kernel records: then the time alone is not measured
        alone = (f"{kernel_ms:.5f} ms on the device (share of the bound {b_ms / kernel_ms:.4f})" if kernel_ms
                 else "not measured (the profiler recorded none of its kernels)")
        print(f"timing [{card}] {label}: {tag} wrapper {ms:.5f} ms, bound {b_ms:.5f} ms ({b_by}, roofline share"
              f" {b_ms / ms:.4f}), plain {plain_ms:.5f} ms, {library_name} {lib_text}{old_text}; the kernel alone"
              f" {alone}, {ops:.1f} device operations per call")
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
    res_c = {}
    for tier_name in ("graph", "eager"):
        with tier(tier_name):
            res_c[tier_name], launches, log = run_path_c(device, k3, tier_name)
        print(f"path C [{card}]: binary AUROC/AP at 200 thresholds over 1,000,000 scores, multiclass and multilabel"
              f" AUROC at C=5 over 200,000 rows: functional {res_c[tier_name]['functional_s']:.4f} s for the four calls;"
              f" collection of BinaryAUROC + BinaryAveragePrecision, 100 x 10,000: {res_c[tier_name]['forward_per_s']:.1f}"
              f" forward/s, {res_c[tier_name]['samples_per_s']:.4g} samples/s; K3 launches {launches}; {log.line()},"
              f" {res_c[tier_name]['device_ops_per_step']:.1f} device operations/step; values {res_c[tier_name]['values']}")
        if tier_name == "graph":
            launches_c = launches
    same_on_both_tiers("path C", *({k: v for k, v in res_c[t].items() if k in ("values", "collection", "last_batch", "modules")}
                                   for t in ("graph", "eager")))
    res_d = {}
    for tier_name in ("graph", "eager"):
        with tier(tier_name):
            res_d[tier_name], launches, logs = run_path_d(device, k2, tier_name)
        r = res_d[tier_name]
        print(f"path D [{card}]: BinaryAUROC sketch (2048 bins) over 16 x 65,536: {r['binary_samples_per_s']:.4g}"
              f" samples/s, AUROC {r['auroc_sketch']:.7f} vs exact {r['auroc_exact']:.7f} (|diff|"
              f" {r['abs_error']:.3g}, bound {r['error_bound']:.3g}); MulticlassAUROC sketch C=5 over 200,000"
              f" rows in 20 updates: {r['multiclass_samples_per_s']:.4g} samples/s, AUROC"
              f" {r['multiclass_auroc_sketch']:.7f}; K2 launches {launches}, branches"
              f" {k2.branch(2048, device)} / {k2.branch(5 * 2048, device)}; binary {logs[0].line()},"
              f" {r['device_ops_per_update']:.1f} device operations/update; multiclass {logs[1].line()}")
        if tier_name == "graph":
            launches_d = launches
    same_on_both_tiers("path D", *({k: res_d[t][k] for k in ("auroc_sketch", "auroc_exact", "multiclass_auroc_sketch")}
                                   for t in ("graph", "eager")))

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

    # ---- paths E and F: the binary and multilabel stat scores, confusion matrices, fixed-point
    # metrics and calibration error, each path's counts set to 0 just before it
    res_e = {}
    for tier_name in ("graph", "eager"):
        with tier(tier_name):
            res_e[tier_name], launches, log = run_path_e(device, k1, lb, tb, tier_name)
        r = res_e[tier_name]
        print(f"path E [{card}]: BASELINE config #2 functional calls over 1,000,000 samples in {r['functional_s']:.4f} s;"
              f" collection of BinaryAccuracy + BinaryPrecision + BinaryRecall + BinaryF1Score, 100 x 10,000:"
              f" {r['forward_per_s']:.1f} forward/s, {r['samples_per_s']:.4g} samples/s; {log.line()},"
              f" {r['device_ops_per_step']:.1f} device operations/step; MultilabelF1Score + MultilabelConfusionMatrix L=5:"
              f" {r['multilabel_rows_per_s']:.4g} rows/s; MulticlassConfusionMatrix C=1000: {r['confmat_1000_rows_per_s']:.4g}"
              f" rows/s; K1 launches {launches}; values {r['values']}")
        if tier_name == "graph":
            launches_e = launches
    same_on_both_tiers("path E", *({k: res_e[t][k] for k in ("values", "last_batch")} for t in ("graph", "eager")))
    res_f = {}
    for tier_name in ("graph", "eager"):
        with tier(tier_name):
            res_f[tier_name], launches3, launches2, log = run_path_f(device, k3, k2, lb, tb, tier_name)
        r = res_f[tier_name]
        print(f"path F [{card}]: collection of Binary RecallAtFixedPrecision + PrecisionAtFixedRecall +"
              f" SpecificityAtSensitivity + AUROC at 200 thresholds, 100 x 10,000: {r['forward_per_s']:.1f} forward/s,"
              f" {r['samples_per_s']:.4g} samples/s; {log.line()}, {r['device_ops_per_step']:.1f} device operations/step;"
              f" multiclass C=5 groups over 200,000 rows: binned {r['binned_rows_per_s']:.4g} rows/s, sketch"
              f" {r['sketch_rows_per_s']:.4g} rows/s; MulticlassCalibrationError C=1000: {r['calibration_1000_rows_per_s']:.4g}"
              f" rows/s; K3 launches {launches3}, K2 sketch_update launches {launches2}; values {r['values']}")
        if tier_name == "graph":
            launches_f3, launches_f2 = launches3, launches2
    same_on_both_tiers("path F", *({k: res_f[t][k] for k in ("values", "last_batch", "binned_values", "sketch_values")}
                                   for t in ("graph", "eager")))
    res_g = {}
    for tier_name in ("graph", "eager"):
        with tier(tier_name):
            res_g[tier_name], launches = run_path_g(device, k1, tier_name)
        r = res_g[tier_name]
        print(f"path G [{card}]: bench.py's headline protocol, C=5, 100 x 10,000 int32 labels (seed 7): host_api_rate"
              f" {r['host_api_rate']:.6g} updates/s (update_batches + compute, five with a reset before each, best of 3);"
              f" one sweep_fn sweep {r['wall_one_sweep_s'] * 1e3:.4f} ms wall; sweep_fn {r['sweep_log']};"
              f" update_batches {r['update_batches_log']}; K1 launches {launches}; values {r['values']};"
              f" aggregation {r['aggregation']}")
        if tier_name == "graph":
            launches_g = launches
    same_on_both_tiers("path G", *({k: res_g[t][k] for k in ("values", "sweep", "aggregation")} for t in ("graph", "eager")))

    # ---- path H: BASELINE config #5 (retrieval) at full size, then the ragged set; path I:
    # composition and set_dtype on path A's data
    res_h, ragged = {}, {}
    for tier_name in ("graph", "eager"):
        with tier(tier_name):
            res_h[tier_name] = run_path_h(device, tier_name)
            ragged[tier_name], captures, replays = run_path_h_ragged(device, tier_name)
        curve = res_h[tier_name].pop("RetrievalPrecisionRecallCurve")
        print(f"path H [{card}]: RetrievalPrecisionRecallCurve over the same 2^20 documents, max_k {curve['max_k']} from the"
              f" longest query, {tier_name} tier: one compute {curve['compute_wall_ms']:.4f} ms wall (its first: the graph"
              f" tier captures), {curve['peak_gib']:.3f} GiB of device memory at its peak beyond the state,"
              f" {curve['held_gib']:.3f} GiB more reserved after it, curves within {curve['max_abs_err']:.3g} of numpy")
        res_h[tier_name]["RetrievalPrecisionRecallCurve"] = {"value": curve["value"]}
        for name, r in res_h[tier_name].items():
            if name == "RetrievalPrecisionRecallCurve":
                continue
            print(f"path H [{card}]: BASELINE config #5, {name} over 2^20 documents and 10,000 sorted query ids (seed 9),"
                  f" {tier_name} tier: {r['samples_per_s']:.6g} samples/s (3 * n / best of 3 windows of 3 reset + update +"
                  f" compute), one compute {r['compute_wall_ms']:.4f} ms wall (median {r['compute_wall_ms_median']:.4f}),"
                  f" value {r['value']!r} (numpy {r['numpy']!r}); {r['captures']} captures, {r['replays']} replays,"
                  f" {r['compute_fallbacks']} compute fallbacks, {r['update_fallbacks']} updates eager (cat-state appends)")
        print(f"path H ragged [{card}] {tier_name} tier: 50,000 documents, 1,000 unsorted query ids, tied scores,"
              f" ignore_index=-1: {len(ragged[tier_name])} configs of all ten metrics equal numpy within {RETRIEVAL_TOL}"
              f" ('error' raised in {sum(v == 'raised' for v in ragged[tier_name].values())}); {captures} captures,"
              f" {replays} replays, no compute fallback")
    same_on_both_tiers("path H", *({k: v["value"] for k, v in res_h[t].items()} for t in ("graph", "eager")))  # the curve too
    same_on_both_tiers("path H ragged", ragged["graph"], ragged["eager"])
    res_i = {}
    for tier_name in ("graph", "eager"):
        with tier(tier_name):
            res_i[tier_name], launches, mean_bits, lines = run_path_i(device, k1, preds_a, target_a, pa, ta, tier_name)
        res_i[tier_name]["mean"] = mean_bits
        print(f"path I [{card}] {tier_name} tier: MulticlassAccuracy + MulticlassF1Score and abs(acc - f1), 20 x 10,000"
              f" int32 labels: values {res_i[tier_name]['compute']}, K1 launches {launches}; acc + f1 {lines['sum']};"
              f" abs(acc - f1) {lines['gap']}; MeanMetric after set_dtype(torch.float64) equal across tiers bit for bit")
        if tier_name == "graph":
            launches_i = launches
    same_on_both_tiers("path I", res_i["graph"], res_i["eager"])

    # ---- path J: the rest of classification at full width (J1 on path B's logits, J2 COCO's 80
    # labels, J3 binary fairness), then the ragged set J4, K1's count set to 0 just before
    res_j = {}
    for tier_name in ("graph", "eager"):
        with tier(tier_name):
            res_j[tier_name], launches, lines_j = run_path_j(device, k1, k2, lb, tb, tier_name)
        for part in ("J1", "J2", "J3", "J4"):
            loops = "; ".join(f"{k[3:]} {v}" for k, v in lines_j.items() if k.startswith(part + " "))
            print(f"path {part} [{card}] {tier_name} tier: {lines_j[part]}{'; ' + loops if loops else ''}")
        print(f"path J [{card}] {tier_name} tier: K1 launches {launches}; values"
              f" {json.dumps({k: v for k, v in res_j[tier_name].items() if k != 'J4' and not isinstance(v, tuple)})}")
        if tier_name == "graph":
            launches_j = launches
    same_on_both_tiers("path J", res_j["graph"], res_j["eager"])

    # ---- path K: regression at full width (K1-K4) and the ragged set K5, on both tiers; the slice
    # reaches no Pallas kernel's counterpart, so every kernel's count stays 0 from just before it
    from torchmetrics_tpu_torch.ops.bincount import LaunchCounter

    for counter in LaunchCounter.ALL:
        counter.launches = 0
    started_k = time.perf_counter()
    k4_data = path_k4_data()
    res_k = {}
    for tier_name in ("graph", "eager"):
        with tier(tier_name):
            r = res_k[tier_name] = {}
            r["K1"], line, _ = run_path_k1(device, tier_name)
            print(f"path K1 [{card}] {tier_name} tier: 13 regression metrics, 100 x 10,000 lognormal targets (seed 29): {line}")
            r["K2"], line, _ = run_path_k2(device, tier_name)
            print(f"path K2 [{card}] {tier_name} tier: 6 metrics over 8 outputs, 100 x 10,000 rows (seed 31): {line}")
            r["K3"], line, _ = run_path_k3(device, tier_name)
            print(f"path K3 [{card}] {tier_name} tier: {line}")
            r["K4"], line = run_path_k4(device, tier_name, data=k4_data)
            print(f"path K4 [{card}] {tier_name} tier: {line}")
            r["K5"] = run_path_k_ragged(device, tier_name)
            print(f"path K5 [{card}] {tier_name} tier: {len(K5_CLASSES)} class configurations (forward x 4 and compute),"
                  f" one sample through R2Score, {len(K5_FUNCTIONS)} functional calls agree with the CPU")
    same_on_both_tiers("path K", res_k["graph"], res_k["eager"])
    if any(counter.launches for counter in LaunchCounter.ALL):
        raise AssertionError(f"path K launched a kernel: {[c.launches for c in LaunchCounter.ALL]}")
    del k4_data
    print(f"path K [{card}]: both tiers bit-equal, no kernel launched, {time.perf_counter() - started_k:.1f} s")
    # K1 at J3's fairness shape: the fused index 4 * group + 2 * target + pred over 32 bins
    _, dev_j = path_j_data(device)
    fused_j = {}
    for rows in (10_000, 1_000_000):
        p01 = (dev_j["b_scores"][:rows] > 0.5).long()
        fused_j[rows] = (dev_j["b_groups"][:rows].long() * 4 + dev_j["b_target"][:rows].long() * 2 + p01).contiguous()
    t_j = {rows: timing(
        f"path J3 fairness shape (fused index, N={rows:,} int64, 32 int64 bins)",
        lambda f=f: k1.bincount(f, 32, dtype=i64), lambda f=f: k1.bincount_plain(f, 32, dtype=i64),
        lambda f=f: torch.bincount(f, minlength=32), rows * 8 + 32 * 8, rows, 2000 if rows == 10_000 else 200,
    ) for rows, f in fused_j.items()}

    gen = torch.Generator(device).manual_seed(3)
    p01 = (torch.rand(1_000_000, device=device, generator=gen) > 0.5).to(torch.int32)
    t01 = torch.randint(0, 2, (1_000_000,), device=device, dtype=torch.int32, generator=gen)
    fused01 = t01.long() * 2 + p01.long()
    t_e = timing(
        "path E binary shape (confusion, N=1,000,000 int32 labels, 4 int64 bins: the worst contention)",
        lambda: k1.confusion_counts(p01, t01, 2, dtype=i64), lambda: k1.confusion_counts_plain(p01, t01, 2, dtype=i64),
        lambda: torch.bincount(fused01, minlength=4), 1_000_000 * 8 + 4 * 8, 1_000_000, 200,
    )

    # ---- path L: distributed state sync and the wrappers (L1 a one-rank NCCL world in this process,
    # L2 two gloo ranks on this card, L3 the six wrappers), every kernel's count set to 0 just before
    started_l = time.perf_counter()
    rng = np.random.RandomState(9)  # path H's documents (bench.py:2193-2197)
    h_docs = (rng.rand(1 << 20).astype(np.float32), rng.randint(0, 2, size=1 << 20).astype(np.int32),
              np.sort(rng.randint(0, 10_000, size=1 << 20)).astype(np.int32))
    line_l1, launches_l1 = run_path_l1(device, (pa, ta), tuple(torch.from_numpy(x).to(device) for x in h_docs), batch_a)
    print(f"path L1 [{card}]: one-rank NCCL world (torch {torch.__version__}, NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}):"
          f" {line_l1}; K1 launches {launches_l1}")
    t_l2 = time.perf_counter()
    cases_l2, launches_l2 = run_path_l2(device)
    for name, (_, reports, check) in cases_l2.items():
        timing_text = "; ".join(f"rank {r}: sync + compute {rep['compute_ms']:.3f} ms, {rep['gathers']} gathers"
                                f" ({rep['gather_ms']:.3f} ms), {rep['bytes']:,} bytes received" for r, rep in enumerate(reports))
        print(f"path L2 [{card}] {name}: two ranks on {device} through gloo (host memory), both ranks the same bits;"
              f" rank 0 {check}; {timing_text}")
    print(f"path L2 [{card}]: {time.perf_counter() - t_l2:.1f} s with the workers' start; kernel launches of both ranks"
          f" {launches_l2}")
    launches_l2_k1, launches_l2_k3, launches_l2_k2 = (launches_l2[k] for k in ("K1", "K3 binned_confmat", "K2 sketch_update"))
    if min(launches_l2_k1, launches_l2_k3, launches_l2_k2) == 0:
        raise AssertionError(f"path L2: a kernel of the path was not launched: {launches_l2}")
    data_l3 = path_l3_data(device, logits_b, target_b, lb, tb)
    res_l3, cpu_boot = {}, None
    for tier_name in ("graph", "eager"):
        with tier(tier_name):
            res_l3[tier_name], lines_l3, launches, cpu_boot = run_path_l3(device, tier_name, data_l3, cpu_boot)
        for name, line in lines_l3.items():
            print(f"path L3 [{card}] {name}: {line}")
        if tier_name == "graph":
            launches_l3 = launches
    same_on_both_tiers("path L3", res_l3["graph"], res_l3["eager"])
    del data_l3
    print(f"path L [{card}]: {time.perf_counter() - started_l:.1f} s")

    kernels = [{
        "name": "bincount", "route": "cuda", "source": "torchmetrics_tpu_torch/csrc/bincount.cu",
        "replaces": "torchmetrics_tpu/ops/pallas_hist.py:28",
        "launches": launches_a + launches_b + launches_e + launches_g + launches_i + launches_j + launches_l1 + launches_l2_k1
        + launches_l3,
        "max_abs_err": max_err, **t_a, "binary_4_bins": t_e, "fairness_32_bins": t_j[10_000],
        "fairness_32_bins_1m": t_j[1_000_000],
    }, {
        "name": "curve_counts", "entry": "binned_confmat", "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/curve_counts.cu", "replaces": "torchmetrics_tpu/ops/pallas_curve.py:44",
        "launches": launches_c + launches_f3 + launches_l2_k3, "max_abs_err": 0.0, **t_k3["forward"],
    }, {
        "name": "hist_pair", "entry": "sketch_update", "route": "cuda", "source": "torchmetrics_tpu_torch/csrc/hist_pair.cu",
        "replaces": "torchmetrics_tpu/ops/pallas_hist.py:92", "launches": launches_d + launches_f2 + launches_l2_k2,
        "max_abs_err": errors["K2"], **t_sketch["path D binary shape"], "hist_pair": t_k2["path D binary shape"],
    }]
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s from start to the kernels line")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--sync-worker":  # one rank of path L2, started by run_path_l2
        sys.exit(l2_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4], json.loads(sys.argv[5]), sys.argv[6]))
    sys.exit(main())
