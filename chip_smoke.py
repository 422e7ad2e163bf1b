#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card, check it, and time its kernel.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``torchmetrics_tpu_torch/csrc`` and then:

1. holds kernel K1 (``csrc/bincount.cu``) against its plain PyTorch version on the card, for
   both of its loaders, with exact equality;
2. path A, the benchmark's headline (``bench.py``): the four-metric multiclass collection at
   C = 5 over 1,000,000 int32 labels in 100 ``forward`` calls of 10,000, then ``compute()``;
3. path B, shaped like ImageNet validation: C = 1000 over 50,000 float32 logit rows in 50
   batches of 1,000, with ``ignore_index=-1`` on 1% of the targets; its 1M-bin confusion count
   takes the kernel's global-memory branch;
4. times K1 with CUDA events beside its bound, its plain version and ``torch.bincount``.

Counts must equal a host ``np.bincount`` confusion matrix exactly, and metric values the numpy
formulas within 1e-6. Every check raises, so a failed phase ends the run with a non-zero exit.
The last line is ``{"ok": true, "device": {...}}``; the line before it lists the kernels.
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


def bound(n_bytes: int, n_ops: int):
    """Least time in ms for the work, and what sets it."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_checks(k1, device):
    """K1 against its plain version on the card, both loaders, exact. Returns (cases, max abs error)."""
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
    for dtype in (torch.int32, torch.int64):
        empty = torch.empty(0, dtype=dtype, device=device)
        check(f"bincount N=0 {dtype}", k1.bincount(empty, 25), k1.bincount_plain(empty, 25))
        for length in (1, 25, 1000, 40_000, bins_max, bins_max + 1, 1_000_000):
            for n in (1, 4097, 1_000_003):
                x = gen.randint(-3, length + 3, n).astype(np.int64)
                if dtype == torch.int64:
                    x[::5] += 2**31  # above int32: must be dropped, never wrapped into a bin
                    x[1::7] = -(2**40)
                xt = torch.from_numpy(x).to(device=device, dtype=dtype)
                check(f"bincount n={n} length={length} {dtype}", k1.bincount(xt, length), k1.bincount_plain(xt, length))
    big = torch.from_numpy(gen.randint(0, 25, 2**26).astype(np.int32)).to(device)
    check("bincount N=2^26 length=25", k1.bincount(big, 25), k1.bincount_plain(big, 25))
    for pd, td in ((torch.int32, torch.int32), (torch.int64, torch.int32), (torch.int32, torch.int64), (torch.int64, torch.int64)):
        empty_p = torch.empty(0, dtype=pd, device=device)
        empty_t = torch.empty(0, dtype=td, device=device)
        check("confusion N=0", k1.confusion_counts(empty_p, empty_t, 5), k1.confusion_counts_plain(empty_p, empty_t, 5))
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
                          k1.confusion_counts(pt, tt, c, **kw), k1.confusion_counts_plain(pt, tt, c, **kw))
    big_p = torch.from_numpy(gen.randint(0, 5, 2**26).astype(np.int32)).to(device)
    big_t = big % 5
    check("confusion N=2^26 C=5", k1.confusion_counts(big_p, big_t, 5), k1.confusion_counts_plain(big_p, big_t, 5))
    torch.cuda.synchronize()
    return len(errors), max(errors)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 1
    from torchmetrics_tpu_torch.ops import _build
    from torchmetrics_tpu_torch.ops import bincount as k1

    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    seconds = _build.build(["bincount"])
    print(f"build: csrc/bincount.cu in {seconds:.2f} s")
    for line in _build.build_log("bincount").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    print(f"K1 shared-memory branch holds up to {k1.shared_bins_max(device)} bins")

    cases, max_err = kernel_checks(k1, device)
    print(f"K1 vs plain version on the card: equal in all {cases} cases (max abs err {max_err})")

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

    # ---- K1 timings at the main path's shapes
    def timing(label, kernel, plain, library, n_bytes, n_ops, iters):
        ms, plain_ms, lib_ms = time_ms(kernel, iters), time_ms(plain, iters), time_ms(library, iters)
        b_ms, b_by = bound(n_bytes, n_ops)
        print(f"timing [{card}] {label}: K1 wrapper {ms:.5f} ms, bound {b_ms:.5f} ms ({b_by}, roofline share"
              f" {b_ms / ms:.4f}), plain {plain_ms:.5f} ms, torch.bincount {lib_ms:.5f} ms")
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}

    pa_b, ta_b = pa[:batch_a], ta[:batch_a]
    fused_a = ta_b.long() * num_a + pa_b.long()
    t_a = timing(
        f"path A shape (confusion, N={batch_a}, int32, {num_a**2} bins)",
        lambda: k1.confusion_counts(pa_b, ta_b, num_a), lambda: k1.confusion_counts_plain(pa_b, ta_b, num_a),
        lambda: torch.bincount(fused_a, minlength=num_a**2), batch_a * 8 + num_a**2 * 4, batch_a, 2000,
    )
    pb_b = torch.argmax(lb[:batch_b], dim=1)
    tb_b = tb[:batch_b]
    keep_b = (tb_b >= 0)
    fused_b = (tb_b * num_b + pb_b)[keep_b]
    timing(
        f"path B shape (confusion, N={batch_b}, int64, {num_b**2} bins, ignore_index)",
        lambda: k1.confusion_counts(pb_b, tb_b, num_b, ignore_index=-1),
        lambda: k1.confusion_counts_plain(pb_b, tb_b, num_b, ignore_index=-1),
        lambda: torch.bincount(fused_b, minlength=num_b**2), batch_b * 16 + num_b**2 * 4, batch_b, 500,
    )
    big = torch.from_numpy(np.random.RandomState(2).randint(0, 25, 2**26).astype(np.int32)).to(device)
    timing(
        "index stream N=2^26 int32, 25 bins",
        lambda: k1.bincount(big, 25), lambda: k1.bincount_plain(big, 25),
        lambda: torch.bincount(big, minlength=25), 2**26 * 4 + 25 * 4, 2**26, 20,
    )

    kernels = [{
        "name": "bincount", "route": "cuda", "source": "torchmetrics_tpu_torch/csrc/bincount.cu",
        "replaces": "torchmetrics_tpu/ops/pallas_hist.py:28", "launches": launches_a + launches_b,
        "max_abs_err": max_err, **t_a,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
