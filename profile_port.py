#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 profile_port.py

For paths A-H, J1-J3 and K1-K4 of ``chip_smoke.py`` (the same metrics, shapes and seeds), it warms up, then
traces 20 steps with ``torch.profiler`` (a collection's ``forward`` in A, B, C, E and F, the sketch's
``update`` in D: ``BinaryAUROC`` over 65,536 scores and ``MulticlassAUROC`` at C = 5 over 10,000
rows; in E the binary stat-score collection, in F the binned fixed-point collection with
``BinaryAUROC``; in G one ``reset`` + ``update_batches`` + ``compute`` of the headline collection
over bench.py's 100 x 10,000 stack, and one ``sweep_fn`` call; in H the compute of ``RetrievalMAP``
and ``RetrievalNormalizedDCG`` over 2^20 documents, alone and with its ``reset`` + ``update``; in J1-J3
one call of each of the part's loops: ``path_j_metrics`` of ``chip_smoke.py``, with ``BinaryFairness``
in J3; in K1 and K2 one forward of the collection, in K3 one Kendall compute over 50,000 pairs and
one Spearman compute over 1,000,000, in K4 one call of each of its five metrics) and prints per
step: the host's wall
time, the host's aten operations, the device's busy time (the union of its kernel and memset
intervals), the device's idle share, the device operations launched, each port kernel's device
time and launches, the device operations that take the most time, every device operation by name
with its count per step, and the host operations that take the most host time. Each path runs on
the graph tier (captured CUDA graphs, the default; the sketches' updates with ``fast_update``) and
then on the eager tier (``TM_TPU_FAST_DISPATCH=0``); each line names its tier. The card's name and power limit head every
line. It fails without a CUDA card.
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
TIERS = ("graph", "eager")
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
    for tier in TIERS:
        with chip_smoke.tier(tier):
            profile_path(card, f"path A (C=5, 10,000 int32 labels/step), {tier} tier",
                         chip_smoke.collection(5, validate_args=False), _batches(preds_a, target_a, 10_000))

    rng = np.random.RandomState(0)
    n_b, num_b = 50_000, 1000
    logits_b = torch.from_numpy(rng.standard_normal((n_b, num_b)).astype(np.float32)).to(device)
    target_b = rng.randint(0, num_b, n_b).astype(np.int64)
    target_b[rng.rand(n_b) < 0.01] = -1
    for tier in TIERS:
        with chip_smoke.tier(tier):
            profile_path(card, f"path B (C=1000, 1,000 f32 logit rows/step), {tier} tier",
                         chip_smoke.collection(num_b, ignore_index=-1), _batches(logits_b, torch.from_numpy(target_b).to(device), 1000))

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.classification import BinaryAUROC, BinaryAveragePrecision, MulticlassAUROC

    rng = np.random.RandomState(5)
    preds_c = torch.from_numpy(rng.rand(1_000_000).astype(np.float32)).to(device)
    target_c = torch.from_numpy(rng.randint(0, 2, size=1_000_000).astype(np.int32)).to(device)
    for tier in TIERS:
        with chip_smoke.tier(tier):
            curves = MetricCollection([BinaryAUROC(thresholds=200), BinaryAveragePrecision(thresholds=200)])
            profile_path(card, f"path C (BinaryAUROC + BinaryAveragePrecision, T=200, 10,000 f32 scores/step), {tier} tier",
                         curves, _batches(preds_c, target_c, 10_000))

    rng = np.random.RandomState(17)
    preds_d = rng.uniform(0.0, 1.0, (32, 65_536)).astype(np.float32)
    target_d = (rng.uniform(0, 1, (32, 65_536)) < np.clip(preds_d * 0.8 + 0.1, 0, 1)).astype(np.int32)
    mc_preds = torch.from_numpy(rng.rand(250_000, 5).astype(np.float32)).to(device)
    mc_target = torch.from_numpy(rng.randint(0, 5, 250_000).astype(np.int32)).to(device)
    for tier in TIERS:
        with chip_smoke.tier(tier):
            sketch = BinaryAUROC(approx="sketch", sketch_bins=2048)
            mc_sketch = MulticlassAUROC(num_classes=5, approx="sketch", sketch_bins=2048)
            sketch.fast_update = mc_sketch.fast_update = True  # the update-only graph tier
            profile_path(card, f"path D (BinaryAUROC sketch, 2048 bins, 65,536 f32 scores/update), {tier} tier",
                         sketch.update, _batches(torch.from_numpy(preds_d.reshape(-1)).to(device),
                                                 torch.from_numpy(target_d.reshape(-1)).to(device), 65_536))
            profile_path(card, f"path D (MulticlassAUROC sketch, C=5, 2048 bins, 10,000 f32 score rows/update), {tier} tier",
                         mc_sketch.update, _batches(mc_preds, mc_target, 10_000))

    from torchmetrics_tpu_torch.classification import (
        BinaryAccuracy,
        BinaryF1Score,
        BinaryPrecision,
        BinaryPrecisionAtFixedRecall,
        BinaryRecall,
        BinaryRecallAtFixedPrecision,
        BinarySpecificityAtSensitivity,
    )

    rng = np.random.RandomState(3)  # path E: bench.py:2084-2088, in its order
    rng.randint(0, 5, size=1_000_000), rng.randint(0, 5, size=1_000_000)  # the functional calls' multiclass labels
    preds_e = torch.from_numpy(rng.rand(1_000_000).astype(np.float32)).to(device)
    target_e = torch.from_numpy(rng.randint(0, 2, size=1_000_000).astype(np.int32)).to(device)
    for tier in TIERS:
        with chip_smoke.tier(tier):
            binary = MetricCollection([BinaryAccuracy(), BinaryPrecision(), BinaryRecall(), BinaryF1Score()])
            profile_path(card, "path E (BinaryAccuracy + BinaryPrecision + BinaryRecall + BinaryF1Score, 10,000 f32"
                         f" scores/step), {tier} tier", binary, _batches(preds_e, target_e, 10_000))
    for tier in TIERS:
        with chip_smoke.tier(tier):
            fixed = MetricCollection([BinaryRecallAtFixedPrecision(0.5, thresholds=200),
                                      BinaryPrecisionAtFixedRecall(0.5, thresholds=200),
                                      BinarySpecificityAtSensitivity(0.5, thresholds=200), BinaryAUROC(thresholds=200)])
            profile_path(card, "path F (Binary RecallAtFixedPrecision + PrecisionAtFixedRecall + SpecificityAtSensitivity"
                         f" + AUROC, T=200, 10,000 f32 scores/step), {tier} tier", fixed, _batches(preds_c, target_c, 10_000))

    rng = np.random.RandomState(7)  # path G: bench.py:35-39
    stack = [torch.from_numpy(rng.randint(0, 5, size=(100, 10_000)).astype(np.int32)).to(device) for _ in range(2)]
    for tier in TIERS:
        with chip_smoke.tier(tier):
            headline = chip_smoke.collection(5, validate_args=False)
            headline(stack[0][0], stack[1][0])  # forms the compute groups, as bench.py:78 does
            headline.reset()

            def sweep(preds, target, mc=headline):
                mc.reset()
                mc.update_batches(preds, target)
                return mc.compute()

            profile_path(card, f"path G (reset + update_batches + compute over 100 x 10,000 int32 labels), {tier} tier",
                         sweep, [tuple(stack)] * (5 + STEPS))
            profile_path(card, f"path G (sweep_fn over 100 x 10,000 int32 labels), {tier} tier", headline.sweep_fn(),
                         [tuple(stack)] * (5 + STEPS))

    from torchmetrics_tpu_torch.retrieval import RetrievalMAP, RetrievalNormalizedDCG

    n = 1 << 20  # path H: BASELINE config #5, bench.py:2193-2197
    rng = np.random.RandomState(9)
    preds_h = torch.from_numpy(rng.rand(n).astype(np.float32)).to(device)
    target_h = torch.from_numpy(rng.randint(0, 2, size=n).astype(np.int32)).to(device)
    indexes_h = torch.from_numpy(np.sort(rng.randint(0, 10_000, size=n)).astype(np.int32)).to(device)
    for tier in TIERS:
        with chip_smoke.tier(tier):
            for cls in (RetrievalMAP, RetrievalNormalizedDCG):
                m = cls()
                m.update(preds_h, target_h, indexes=indexes_h)

                def compute(m=m):
                    m._computed = None  # the compute of the same state again, without an update
                    return m.compute()

                profile_path(card, f"path H ({cls.__name__} compute, 2^20 documents, 10,000 queries), {tier} tier",
                             compute, [()] * (5 + STEPS))
                profile_path(card, f"path H ({cls.__name__} reset + update + compute, 2^20 documents), {tier} tier",
                             lambda m=m: (m.reset(), m.update(preds_h, target_h, indexes=indexes_h), m.compute()),
                             [()] * (5 + STEPS))

    from torchmetrics_tpu_torch.classification import BinaryFairness

    _, dev_j = chip_smoke.path_j_data(device)  # path J: one step is one call of each of the part's loops
    parts = {
        "J1": ("C=1000 kappa + MCC + Jaccard, specificity + Hamming, Dice, hinge x2; 1,000 f32 logit rows",
               _batches(logits_b, torch.from_numpy(target_b).to(device), 1000)),
        "J2": ("L=80 Jaccard + MCC, Hamming, exact match, three ranking metrics; 10,000 rows",
               _batches(dev_j["ml_preds"], dev_j["ml_target"], 10_000) * 3),  # 10 batches, each 3 times
        "J3": ("8 groups: BinaryFairness, BinaryGroupStatRates, kappa + MCC, specificity, squared hinge; 10,000 scores",
               [(dev_j["b_scores"][i:i + 10_000], dev_j["b_target"][i:i + 10_000], dev_j["b_groups"][i:i + 10_000])
                for i in range(0, 250_000, 10_000)]),
    }
    for part, (what, batches) in parts.items():
        for tier in TIERS:
            with chip_smoke.tier(tier):
                loops = list(chip_smoke.path_j_metrics(part).values())
                fairness = BinaryFairness(8) if part == "J3" else None

                def step(*batch, loops=loops, fairness=fairness):
                    if fairness is not None:
                        fairness(*batch)
                        loops[0](*batch)  # BinaryGroupStatRates takes the groups
                        return [m(*batch[:2]) for m in loops[1:]]
                    return [m(*batch) for m in loops]

                profile_path(card, f"path {part} ({what}/step), {tier} tier", step, batches)

    # path K: K1 and K2 one collection forward, K3 one Kendall compute at 50,000 pairs (the slice's
    # only quadratic work) and one Spearman compute at 1,000,000, K4 one call of each of its metrics
    from torchmetrics_tpu_torch.regression import (
        CosineSimilarity,
        KendallRankCorrCoef,
        KLDivergence,
        MeanSquaredLogError,
        SpearmanCorrCoef,
        TweedieDevianceScore,
    )

    for part, what in (("K1", "13 metrics, 10,000 pairs"), ("K2", "6 metrics, 10,000 rows x 8 outputs")):
        preds, target = (torch.from_numpy(a[:25]).to(device) for a in chip_smoke.path_k_data(part))
        for tier in TIERS:
            with chip_smoke.tier(tier):
                profile_path(card, f"path {part} ({what}/step), {tier} tier", chip_smoke.path_k_metrics(part),
                             [(preds[i], target[i]) for i in range(25)])
    x, y, kx, ky = (torch.from_numpy(a).to(device) for a in chip_smoke.path_k3_data())
    k4 = chip_smoke.path_k4_data(n_batches=25)
    k4_dev = {k: torch.from_numpy(v).to(device) for k, v in k4.items()}
    for tier in TIERS:
        with chip_smoke.tier(tier):
            kendall = KendallRankCorrCoef(variant="b", t_test=True)
            kendall.update(kx, ky)
            spearman = SpearmanCorrCoef()
            spearman.update(x, y)

            def compute(m):
                m._computed = None  # the compute of the same state again, without an update
                return m.compute()

            profile_path(card, f"path K3 (KendallRankCorrCoef tau-b + t_test compute, 50,000 pairs), {tier} tier",
                         compute, [(kendall,)] * (5 + STEPS))
            profile_path(card, f"path K3 (SpearmanCorrCoef compute, 1,000,000 pairs), {tier} tier", compute,
                         [(spearman,)] * (5 + STEPS))
            metrics = (CosineSimilarity(reduction="mean"), KLDivergence(), KLDivergence(log_prob=True),
                       TweedieDevianceScore(power=1.5), MeanSquaredLogError())
            keys = (("emb_p", "emb_t"), ("p", "q"), ("log_p", "log_q"), ("predicted", "claim"), ("predicted", "claim"))

            def k4_step(i, metrics=metrics):
                return [m(*(k4_dev[k][i * 1000:(i + 1) * 1000] if k not in ("predicted", "claim")
                            else k4_dev[k][i * 10_000:(i + 1) * 10_000] for k in ks)) for m, ks in zip(metrics, keys)]

            profile_path(card, f"path K4 (cosine 1,000 x 768, KL and KL log_prob 1,000 x 1,000, Tweedie + MSLE"
                         f" 10,000 claims/step), {tier} tier", k4_step, [(i,) for i in range(5 + STEPS)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
