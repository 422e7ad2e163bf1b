#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 profile_port.py

For paths A, B, C and D of ``chip_smoke.py`` (the same metrics, shapes and seeds), it warms up,
then traces 20 steps with ``torch.profiler`` (a collection's ``forward`` in A, B and C, the
sketch's ``update`` in D: ``BinaryAUROC`` over 65,536 scores and ``MulticlassAUROC`` at C = 5 over
10,000 rows) and prints per step: the host's wall time, the device's busy time (the
union of its kernel and memset intervals), the device's idle share, the device operations
launched, each port kernel's device time and launches, the device operations that take the most
time, every device operation by name with its count per step, and the host operations that take
the most host time. The card's name and power limit head
every line. It fails without a CUDA card.
"""
from __future__ import annotations

import re
import sys
import time
from collections import Counter

import numpy as np
import torch

import chip_smoke

STEPS = 20
#: the port's kernels by the names of their CUDA functions
KERNELS = {"K1": ("hist_shared", "hist_global"), "K3": ("binned_confmat", "counts_partial", "counts_reduce"),
           "K2": ("pair_shared", "pair_global", "sketch_update")}


def _device_intervals(prof):
    """(name, start_us, end_us) of every operation that ran on the card."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _short(name: str) -> str:
    """A device operation's name without its namespaces, templates' tails and arguments."""
    name = re.sub(r"^void |at::native::|\(anonymous namespace\)::|std::array<char\*, \d+ul>|at::cuda::detail::", "", name)
    return name.split("(")[0][:80] if not name.startswith("Memcpy") and not name.startswith("Memset") else name


def _busy_us(intervals) -> float:
    busy, end = 0.0, -np.inf
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def profile_path(card: str, label: str, step, batches) -> None:
    """Trace ``step(*batch)`` over 20 batches after 5 warm-up ones."""
    for batch in batches[:5]:  # warm-up: forms compute groups, loads the kernels
        step(*batch)
    steps = batches[5:5 + STEPS]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in steps:
        step(*batch)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in steps:
            step(*batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    intervals = _device_intervals(prof)
    head = f"profile [{card}] {label}"
    print(f"{head}: wall {untraced_ms:.4f} ms/step untraced, {traced_ms:.4f} ms/step traced")
    host = prof.key_averages()
    print(f"{head}: {sum(k.count for k in host if k.key.startswith('aten::')) / STEPS:.1f} aten operations/step on the host")
    for k in sorted(host, key=lambda k: k.self_cpu_time_total, reverse=True)[:8]:
        print(f"{head}: host {k.self_cpu_time_total / 1e3 / STEPS:.4f} ms/step self, {k.count / STEPS:.1f} calls/step  {k.key[:90]}")
    if not intervals:
        print(f"{head}: the profiler recorded no device operations; device time not measured")
        return
    busy_ms = _busy_us(intervals) / 1e3 / STEPS
    print(f"{head}: device busy {busy_ms:.4f} ms/step, idle share {1 - busy_ms / traced_ms:.4f} of the traced"
          f" wall time, {len(intervals) / STEPS:.1f} device operations/step")
    per_name = Counter()
    for name, s, e in intervals:
        per_name[name] += e - s
    for kernel, functions in KERNELS.items():
        launches = Counter()
        kernel_us = 0.0
        for name, s, e in intervals:
            for function in functions:
                if function in name:
                    launches[function] += 1
                    kernel_us += e - s
        if launches:
            print(f"{head}: {kernel} {kernel_us / 1e3 / STEPS:.4f} ms/step on the device, launches/step"
                  f" {({f: c / STEPS for f, c in launches.items()})}")
    for name, us in per_name.most_common(6):
        print(f"{head}: device {us / 1e3 / STEPS:.4f} ms/step  {name[:110]}")
    counts = Counter(_short(name) for name, _, _ in intervals)
    listing = "; ".join(f"{c / STEPS:g} x {name}" for name, c in sorted(counts.items(), key=lambda x: (-x[1], x[0])))
    print(f"{head}: device operations per step by name: {listing}")


def _batches(preds, target, batch: int):
    return [(preds[i * batch:(i + 1) * batch], target[i * batch:(i + 1) * batch]) for i in range(target.shape[0] // batch)]


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_port: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    rng = np.random.RandomState(0)
    preds_a = torch.from_numpy(rng.randint(0, 5, 1_000_000).astype(np.int32)).to(device)
    target_a = torch.from_numpy(rng.randint(0, 5, 1_000_000).astype(np.int32)).to(device)
    profile_path(card, "path A (C=5, 10,000 int32 labels/step)", chip_smoke.collection(5, validate_args=False),
                 _batches(preds_a, target_a, 10_000))

    rng = np.random.RandomState(0)
    n_b, num_b = 50_000, 1000
    logits_b = torch.from_numpy(rng.standard_normal((n_b, num_b)).astype(np.float32)).to(device)
    target_b = rng.randint(0, num_b, n_b).astype(np.int64)
    target_b[rng.rand(n_b) < 0.01] = -1
    profile_path(card, "path B (C=1000, 1,000 f32 logit rows/step)", chip_smoke.collection(num_b, ignore_index=-1),
                 _batches(logits_b, torch.from_numpy(target_b).to(device), 1000))

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import BinaryAUROC, BinaryAveragePrecision, MulticlassAUROC

    rng = np.random.RandomState(5)
    preds_c = torch.from_numpy(rng.rand(1_000_000).astype(np.float32)).to(device)
    target_c = torch.from_numpy(rng.randint(0, 2, size=1_000_000).astype(np.int32)).to(device)
    curves = MetricCollection([BinaryAUROC(thresholds=200), BinaryAveragePrecision(thresholds=200)])
    profile_path(card, "path C (BinaryAUROC + BinaryAveragePrecision, T=200, 10,000 f32 scores/step)", curves,
                 _batches(preds_c, target_c, 10_000))

    rng = np.random.RandomState(17)
    preds_d = rng.uniform(0.0, 1.0, (32, 65_536)).astype(np.float32)
    target_d = (rng.uniform(0, 1, (32, 65_536)) < np.clip(preds_d * 0.8 + 0.1, 0, 1)).astype(np.int32)
    sketch = BinaryAUROC(approx="sketch", sketch_bins=2048)
    profile_path(card, "path D (BinaryAUROC sketch, 2048 bins, 65,536 f32 scores/update)", sketch.update,
                 _batches(torch.from_numpy(preds_d.reshape(-1)).to(device), torch.from_numpy(target_d.reshape(-1)).to(device),
                          65_536))
    mc_preds = torch.from_numpy(rng.rand(250_000, 5).astype(np.float32)).to(device)
    mc_target = torch.from_numpy(rng.randint(0, 5, 250_000).astype(np.int32)).to(device)
    mc_sketch = MulticlassAUROC(num_classes=5, approx="sketch", sketch_bins=2048)
    profile_path(card, "path D (MulticlassAUROC sketch, C=5, 2048 bins, 10,000 f32 score rows/update)", mc_sketch.update,
                 _batches(mc_preds, mc_target, 10_000))
    return 0


if __name__ == "__main__":
    sys.exit(main())
