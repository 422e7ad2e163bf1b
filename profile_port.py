#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one CUDA card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 profile_port.py

For paths A-H, J1-J3, K1-K4, L1-L3 and M1-M3 of ``chip_smoke.py`` (the same metrics, shapes and seeds), it warms up, then
traces 20 steps with ``torch.profiler`` (a collection's ``forward`` in A, B, C, E and F, the sketch's
``update`` in D: ``BinaryAUROC`` over 65,536 scores and ``MulticlassAUROC`` at C = 5 over 10,000
rows; in E the binary stat-score collection, in F the binned fixed-point collection with
``BinaryAUROC``; in G one ``reset`` + ``update_batches`` + ``compute`` of the headline collection
over bench.py's 100 x 10,000 stack, and one ``sweep_fn`` call; in H the compute of ``RetrievalMAP``
and ``RetrievalNormalizedDCG`` over 2^20 documents, alone and with its ``reset`` + ``update``; in J1-J3
one call of each of the part's loops: ``path_j_metrics`` of ``chip_smoke.py``, with ``BinaryFairness``
in J3; in K1 and K2 one forward of the collection, in K3 one Kendall compute over 50,000 pairs and
one Spearman compute over 1,000,000, in K4 one call of each of its five metrics; in L1 one
``compute`` (the state synced, then computed) of path A's collection and of path H's MAP in a
one-rank NCCL world, in L2 the computes of five of path L2's cases on each of two gloo ranks of the
card (started as ``profile_port.py --l2-rank``; three computes for cosine's 614 MB), with the sync's
wall, gathers and bytes per compute, in L3 one step of each of the six wrappers) and prints per
step: the host's wall
time, the host's aten operations, the device's busy time (the union of its kernel and memset
intervals), the device's idle share, the device operations launched, each port kernel's device
time and launches, the device operations that take the most time, every device operation by name
with its count per step, and the host operations that take the most host time. Each path runs on
the graph tier (captured CUDA graphs, the default; the sketches' updates with ``fast_update``) and
then on the eager tier (``TM_TPU_FAST_DISPATCH=0``); each line names its tier. Path M: one compute of
AMI and of NMI over M1's 50,000 labels, one compute of Dunn over M2's 50,000 x 768 embedding, one
``CramersV`` forward over 10,000 of M3's pairs. Path N: one ``update`` of ``KeyedMetric(SumMetric)``
at N = 10,000 (8,192 ids and values), of the keyed sketched ``BinaryAUROC`` (100 keys, 2,048 bins,
8,192 scores), of ``StreamingQuantile`` over 65,536 latencies, and of ``RetrievalMAP(approx="sketch")``
over one query-aligned batch of 100 of path H's queries. Path O: one ``update`` of
``Windowed(BinaryAUROC(approx="sketch"))`` over 65,536 (score, click) pairs, of
``Windowed(MulticlassAccuracy(num_classes=1000))`` over 8,192 labels, of ``Ema(BinaryAUROC(thresholds=200))``
over 65,536 pairs and of ``Windowed(StreamingQuantile)`` over 65,536 latencies (each window 12 deep, the
emissions of its advances included, their graph captured before the trace), one ``DriftMonitor.evaluate`` of path O4's KS and PSI specs (the
window merged anew each call) and one ``TimeSeries`` fold of 1,024 values. The card's name and power
limit head every line. Path P: one ``update`` of ``StructuralSimilarityIndexMeasure(data_range=1.0)``, of
``MultiScaleStructuralSimilarityIndexMeasure``, of ``PeakSignalNoiseRatio`` and of
``VisualInformationFidelity`` over a batch of 8 of P1's
Kodak-sized images (3 x 512 x 768; the updates on the graph tier through ``fast_update``), one compute of
``SpectralDistortionIndex`` over P2's 4 scenes of 31 x 512 x 512 (465 band pairs), one
``pairwise_euclidean_distance`` of P3's 8,192 x 768 rows against 8,192. Path Q: one ``update`` of
``FrechetInceptionDistance`` over 500 of Q1's 2048-d features, one float64 FID compute over 50,000 + 50,000,
one ``KernelInceptionDistance`` compute (100 subsets of 1,000) and one ``SignalDistortionRatio`` update over
100 of Q3's mixtures (2 x 32,000 samples, filter 512). It fails without a CUDA card.
``python3 profile_port.py L`` profiles path L alone, ``M`` path M alone, ``N`` path N alone, ``O`` path O
alone, ``P`` path P alone, ``Q`` path Q alone.
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


def profile_path(card: str, label: str, step, batches, steps: int = STEPS) -> None:
    """Trace ``step(*batch)`` over ``steps`` batches (20) after 5 warm-up ones."""
    for batch in batches[:5]:  # warm-up: forms compute groups, loads the kernels
        step(*batch)
    n_steps = steps
    steps = batches[5:5 + n_steps]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in steps:
        step(*batch)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in steps:
            step(*batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    intervals = _device_intervals(prof)
    head = f"profile [{card}] {label}"
    print(f"{head}: wall {untraced_ms:.4f} ms/step untraced, {traced_ms:.4f} ms/step traced")
    host = prof.key_averages()
    print(f"{head}: {sum(k.count for k in host if k.key.startswith('aten::')) / n_steps:.1f} aten operations/step on the host")
    for k in sorted(host, key=lambda k: k.self_cpu_time_total, reverse=True)[:8]:
        print(f"{head}: host {k.self_cpu_time_total / 1e3 / n_steps:.4f} ms/step self, {k.count / n_steps:.1f} calls/step  {k.key[:90]}")
    if not intervals:
        print(f"{head}: the profiler recorded no device operations; device time not measured")
        return
    busy_ms = _busy_us(intervals) / 1e3 / n_steps
    print(f"{head}: device busy {busy_ms:.4f} ms/step, idle share {1 - busy_ms / traced_ms:.4f} of the traced"
          f" wall time, {len(intervals) / n_steps:.1f} device operations/step")
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
            print(f"{head}: {kernel} {kernel_us / 1e3 / n_steps:.4f} ms/step on the device, launches/step"
                  f" {({f: c / n_steps for f, c in launches.items()})}")
    for name, us in per_name.most_common(6):
        print(f"{head}: device {us / 1e3 / n_steps:.4f} ms/step  {name[:110]}")
    counts = Counter(_short(name) for name, _, _ in intervals)
    listing = "; ".join(f"{c / n_steps:g} x {name}" for name, c in sorted(counts.items(), key=lambda x: (-x[1], x[0])))
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
    part = sys.argv[1:]
    if not part:
        profile_a_to_k(device, card)
    if part in ([], ["L"]):
        profile_l(device, card)
    if part in ([], ["M"]):
        profile_m(device, card)
    if part in ([], ["N"]):
        profile_n(device, card)
    if part in ([], ["O"]):
        profile_o(device, card)
    if part in ([], ["P"]):
        profile_p(device, card)
    if part in ([], ["Q"]):
        profile_q(device, card)
    return 0


def profile_a_to_k(device, card: str) -> None:
    """Paths A-H, J1-J3 and K1-K4."""
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


#: path L2's cases that this script profiles, and the computes it traces of each (cosine's take 0.75 s)
L2_PROFILED = {"A collection": STEPS, "B confusion matrix": STEPS, "H MAP": STEPS, "K1 Pearson": STEPS, "K4 cosine": 3}


def _sync_line(card: str, label: str, m) -> None:
    """The gathers of ``m``'s last compute: how many, their wall on this rank, the bytes received."""
    members = chip_smoke._members(m)
    gathers = sum(len(mm._tm_last_sync["gather_latency_us"]) for mm in members)
    gather_ms = sum(sum(mm._tm_last_sync["gather_latency_us"].values()) for mm in members) / 1e3
    received = sum(mm._tm_last_sync["bytes_received"] for mm in members)
    print(f"profile [{card}] {label}: sync wall {gather_ms:.4f} ms per compute in {gathers} gathers, {received:,} bytes received")


def l2_rank(rank: int, address: str) -> int:
    """One rank of path L2's profile (``profile_port.py --l2-rank``): the gloo world of two on
    ``cuda:0``, its share of each case of ``L2_PROFILED``, then the computes (each a sync) traced."""
    from datetime import timedelta

    import torch.distributed as dist

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = chip_smoke.card_line()
    dist.init_process_group("gloo", init_method=f"tcp://{address}", rank=rank, world_size=2, timeout=timedelta(seconds=120))
    try:
        cases = chip_smoke._l2_cases(device, chip_smoke.L2_SIZES)
        for name, steps in L2_PROFILED.items():
            make, call, batches, shares, _ = cases[name]
            m = make()
            chip_smoke._feed(m, call, [batches[i] for i in shares[rank]])
            label = f"path L2 {name}, rank {rank} of 2 through gloo (sync + compute)"
            profile_path(card, label, lambda m=m: chip_smoke._fresh_compute(m), [()] * (5 + steps), steps=steps)
            _sync_line(card, label, m)
    finally:
        dist.destroy_process_group()
    return 0


def profile_l(device, card: str) -> None:
    """Path L: L1 one compute (sync + compute) of path A's collection and of path H's MAP in a one-rank
    NCCL world; L2 the computes of ``L2_PROFILED`` on two gloo ranks of this card; L3 one step of each
    wrapper on both tiers."""
    import subprocess

    import torch.distributed as dist

    from torchmetrics_tpu_torch.retrieval import RetrievalMAP

    rng = np.random.RandomState(0)
    pa = torch.from_numpy(rng.randint(0, 5, 1_000_000).astype(np.int32)).to(device)
    ta = torch.from_numpy(rng.randint(0, 5, 1_000_000).astype(np.int32)).to(device)
    rng = np.random.RandomState(9)
    hp, ht, hi = (torch.from_numpy(x).to(device) for x in (
        rng.rand(1 << 20).astype(np.float32), rng.randint(0, 2, size=1 << 20).astype(np.int32),
        np.sort(rng.randint(0, 10_000, size=1 << 20)).astype(np.int32)))
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{chip_smoke.free_port()}", rank=0, world_size=1,
                            device_id=device)
    try:
        always = {"distributed_available_fn": lambda: True}
        mc, mp = chip_smoke.collection(5, **always), RetrievalMAP(**always)
        chip_smoke._feed(mc, "forward", _batches(pa, ta, 10_000))
        mp.update(hp, ht, indexes=hi)
        for label, m in (("path L1 A collection, one-rank NCCL world (sync + compute)", mc),
                         ("path L1 H MAP, one-rank NCCL world (sync + compute)", mp)):
            profile_path(card, label, lambda m=m: chip_smoke._fresh_compute(m), [()] * (5 + STEPS))
            _sync_line(card, label, m)
    finally:
        dist.destroy_process_group()

    address = f"127.0.0.1:{chip_smoke.free_port()}"
    procs = [subprocess.Popen([sys.executable, __file__, "--l2-rank", str(r), address], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    for r, p in enumerate(procs):
        out, err = p.communicate(timeout=chip_smoke.L2_LIMIT_S)
        print(out, end="")
        if p.returncode != 0:
            raise RuntimeError(f"path L2 profile: rank {r} failed (exit {p.returncode}):\n{err[-4000:]}")

    rng = np.random.RandomState(0)  # path B's logits
    lb_np = rng.standard_normal((50_000, 1000)).astype(np.float32)
    tb_np = rng.randint(0, 1000, 50_000).astype(np.int64)
    tb_np[rng.rand(50_000) < 0.01] = -1
    lb, tb = torch.from_numpy(lb_np).to(device), torch.from_numpy(tb_np).to(device)
    data = chip_smoke.path_l3_data(device, lb_np, tb_np, lb, tb)
    from torchmetrics_tpu_torch.classification import BinaryAccuracy, MulticlassAccuracy, MulticlassF1Score
    from torchmetrics_tpu_torch.regression import MeanSquaredError, R2Score
    from torchmetrics_tpu_torch.wrappers import (
        BootStrapper,
        ClasswiseWrapper,
        MetricTracker,
        MinMaxMetric,
        MultioutputWrapper,
        MultitaskWrapper,
    )

    a = _batches(*data["a"], 10_000)
    kp, kt = data["k2"]
    k1p, k1t = data["k1"]
    cp, ct, _ = data["c"]
    for tier in TIERS:
        with chip_smoke.tier(tier):
            boot = BootStrapper(MulticlassAccuracy(num_classes=5), num_bootstraps=10, seed=0)
            profile_path(card, f"path L3 BootStrapper (10 copies, 10,000 labels/step), {tier} tier", boot.update, a)
            cw = ClasswiseWrapper(MulticlassF1Score(num_classes=1000, average=None, ignore_index=-1))
            profile_path(card, f"path L3 ClasswiseWrapper (F1 C=1000, 1,000 rows/step), {tier} tier", cw, _batches(lb, tb, 1000))
            mo = MultioutputWrapper(R2Score(), 8)
            profile_path(card, f"path L3 MultioutputWrapper (8 x R2Score, 10,000 rows/step), {tier} tier", mo,
                         [(kp[i], kt[i]) for i in range(kp.shape[0])])
            tracker = MetricTracker(chip_smoke.collection(5))
            tracker.increment()
            profile_path(card, f"path L3 MetricTracker (path A's collection, 10,000 labels/step), {tier} tier", tracker, a)
            mt = MultitaskWrapper({"cls": chip_smoke.collection(5), "reg": MeanSquaredError()})
            profile_path(card, f"path L3 MultitaskWrapper (path A's collection + MSE), {tier} tier", mt,
                         [({"cls": p, "reg": k1p[i]}, {"cls": t, "reg": k1t[i]}) for i, (p, t) in enumerate(a)])
            mm = MinMaxMetric(BinaryAccuracy())
            profile_path(card, f"path L3 MinMaxMetric (BinaryAccuracy, 10,000 scores/step), {tier} tier", mm,
                         _batches(cp, ct, 10_000))


def profile_m(device, card: str) -> None:
    """Path M at its full sizes: one compute of ``AdjustedMutualInfoScore`` and of
    ``NormalizedMutualInfoScore`` over M1's ImageNet-1k labels (50 updates of 1,000), one compute of
    ``DunnIndex`` over M2's embedding (50,000 x 768, 1,000 clusters), one ``forward`` of
    ``CramersV(num_classes=1000, nan_strategy="drop")`` over 10,000 of M3's click-log pairs; each on
    both tiers."""
    import torchmetrics_tpu_torch as tm

    sizes = chip_smoke.M_SIZES
    rows, batch = sizes["m1_rows"], sizes["m1_batch"]
    p, t = (torch.from_numpy(a).to(device) for a in chip_smoke.path_m1_labels(rows, sizes["m1_classes"], 31))
    x, labels = (torch.from_numpy(a).to(device)
                 for a in chip_smoke.path_m2_data(sizes["m2_rows"], sizes["m2_dim"], sizes["m2_clusters"]))
    pairs = [torch.from_numpy(a).to(device) for a in chip_smoke.path_m3_pairs(sizes["m3_pairs"], sizes["m3_classes"])]
    for tier in TIERS:
        with chip_smoke.tier(tier):
            for name in ("AdjustedMutualInfoScore", "NormalizedMutualInfoScore"):
                m = getattr(tm, name)()
                for i in range(rows // batch):
                    m.update(p[i * batch:(i + 1) * batch], t[i * batch:(i + 1) * batch])
                profile_path(card, f"path M1 {name} compute (50,000 labels, 1,000 classes x 1,000 clusters), {tier} tier",
                             lambda m=m: chip_smoke._fresh_compute(m), [()] * (5 + STEPS))
            dunn = tm.DunnIndex()
            for i in range(x.shape[0] // sizes["m2_batch"]):
                dunn.update(x[i * sizes["m2_batch"]:(i + 1) * sizes["m2_batch"]], labels[i * sizes["m2_batch"]:(i + 1) * sizes["m2_batch"]])
            profile_path(card, f"path M2 DunnIndex compute (50,000 x 768 features, 1,000 clusters), {tier} tier",
                         lambda: chip_smoke._fresh_compute(dunn), [()] * (5 + STEPS))
            del dunn
            cramers = tm.CramersV(num_classes=sizes["m3_classes"], nan_strategy="drop")
            profile_path(card, f"path M3 CramersV forward (C = 1000, 10,000 pairs/step, drop), {tier} tier", cramers,
                         _batches(*pairs, sizes["m3_batch"]))


def profile_n(device, card: str) -> None:
    """Path N at its full sizes, one ``update`` a step: the keyed Sum at N = 10,000, the keyed sketched
    AUROC, the keyed ``StreamingQuantile`` on the vmap strategy (64 keys, capacity 8, 256 values; N3's ten
    batches in turn, whose folds are 8 or 16 deep), ``StreamingQuantile`` over 65,536 latencies and
    ``RetrievalMAP(approx="sketch")`` over a query-aligned batch of path H; each on both tiers."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.keyed import KeyedMetric

    sizes = chip_smoke.N_SIZES
    n3 = chip_smoke.path_n3_data()
    n1 = chip_smoke.path_n1_data(dict(sizes, n1_latency_batches=5 + STEPS, n1_cm_batches=1))
    dev = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    keyed_sum = list(zip(*(dev(a) for a in n3["bench"][10_000])))
    auroc = list(zip(*(dev(a) for a in n3["auroc"][:3])))
    keyed_quantile = list(zip(*(dev(a) for a in n3["quantile"]))) * 3
    latencies = [(b,) for b in dev(n1["latencies"])]
    preds, target, indexes = chip_smoke.path_n2_data()["h"]
    cuts = chip_smoke._cuts(indexes, sizes["n2_aligned_queries"])
    docs = [tuple(dev(x[lo:hi]) for x in (preds, target, indexes)) for lo, hi in zip(cuts[:-1], cuts[1:]) if hi > lo]
    for tier in TIERS:
        with chip_smoke.tier(tier):
            km = KeyedMetric(tm.SumMetric(nan_strategy="ignore"), 10_000)
            profile_path(card, f"path N3 keyed Sum update (N = 10,000, 8,192 ids), {tier} tier", km.update, keyed_sum)
            ka = KeyedMetric(tm.classification.BinaryAUROC(approx="sketch", sketch_bins=sizes["n3_auroc_bins"]),
                             sizes["n3_auroc_keys"])
            profile_path(card, f"path N3 keyed sketched BinaryAUROC update (100 keys, 2,048 bins, 8,192 scores), {tier} tier",
                         ka.update, auroc)
            kq = KeyedMetric(tm.StreamingQuantile(capacity=sizes["n3_quantile_capacity"]), sizes["n3_quantile_keys"])
            profile_path(card, f"path N3 keyed StreamingQuantile update (64 keys, capacity 8, 256 values, vmap strategy),"
                         f" {tier} tier", kq.update, keyed_quantile)
            sq = tm.StreamingQuantile(q=(0.5, 0.9, 0.99))
            profile_path(card, f"path N1 StreamingQuantile update (65,536 latencies), {tier} tier", sq.update, latencies)
            mp = tm.RetrievalMAP(approx="sketch")
            profile_path(card, f"path N2 RetrievalMAP(approx='sketch') update (100 queries), {tier} tier",
                         lambda p, t, i: mp.update(p, t, indexes=i), docs)


def profile_o(device, card: str) -> None:
    """Path O at its full sizes, one step a call, each on both tiers: the windowed sketched AUROC, the
    windowed multiclass accuracy, the decayed binned AUROC and the windowed quantile updates, one drift
    evaluation and one live-series fold."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.classification import BinaryAUROC, MulticlassAccuracy
    from torchmetrics_tpu_torch.obs.timeseries import TimeSeries
    from torchmetrics_tpu_torch.online import DriftMonitor, default_drift_specs

    sizes = chip_smoke.O_SIZES
    n = 5 + STEPS
    data = chip_smoke.path_o_data(dict(sizes, o1_batches=1, o2_batches=n, o3_batches=n, o4_stationary=n, o4_shifted=0))
    dev = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    pairs = list(zip(dev(data["o2_scores"]), dev(data["o2_clicks"])))
    labels = list(zip(dev(data["o3_preds"]), dev(data["o3_target"])))
    latencies = [(b,) for b in dev(data["o4_latencies"])]
    reference = data["o4_latencies"][:sizes["o4_reference"]].reshape(-1)
    values = [float(v) for v in data["o4_latencies"][0, :1024]]
    def advanced(window, batches):
        """``window`` after one advance: its emission's graph is captured before the traced steps."""
        for batch in batches[:window.advance_every]:
            window.update(*batch)
        return window

    for tier in TIERS:
        with chip_smoke.tier(tier):
            w = advanced(tm.Windowed(BinaryAUROC(approx="sketch", sketch_bins=sizes["o2_bins"]), 12, advance_every=10), pairs)
            profile_path(card, f"path O2 Windowed sketched BinaryAUROC update (65,536 pairs, 2,048 bins), {tier} tier",
                         w.update, pairs)
            w = advanced(tm.Windowed(MulticlassAccuracy(num_classes=1000), 12, advance_every=10), labels)
            profile_path(card, f"path O3 Windowed MulticlassAccuracy update (8,192 labels, C = 1000), {tier} tier",
                         w.update, labels)
            e = tm.Ema(BinaryAUROC(thresholds=200), decay=chip_smoke.O_DECAY)
            profile_path(card, f"path O2 Ema binned BinaryAUROC update (65,536 pairs, T = 200), {tier} tier", e.update, pairs)
            q = tm.Windowed(tm.StreamingQuantile(q=(0.5, 0.9, 0.99)), 12, advance_every=5)
            profile_path(card, f"path O4 Windowed StreamingQuantile update (65,536 latencies), {tier} tier", q.update,
                         latencies)
            monitor = DriftMonitor(default_drift_specs(q, reference, name=f"profile-{tier}",
                                                       ks_threshold=chip_smoke.O4_KS_THRESHOLD,
                                                       psi_threshold=chip_smoke.O4_PSI_THRESHOLD, windows=((5.0, 1.0),)))
            clock = iter(range(10**6))
            # each evaluation merges the ring anew and reads it to the host once for both detectors
            profile_path(card, f"path O4 DriftMonitor.evaluate (KS and PSI against 655,360 reference latencies), {tier}"
                         " tier", lambda: monitor.evaluate(now=float(next(clock))), [()] * n)
            series = TimeSeries(f"profile.{tier}", device=device)
            profile_path(card, f"TimeSeries fold of 1,024 values (capacity 64, 18 levels), {tier} tier",
                         lambda: series._fold(values), [()] * n)


def profile_p(device, card: str) -> None:
    """Path P at its full widths, one step a call, each on both tiers: P1's SSIM, MS-SSIM, PSNR and VIF
    updates over 8 images, P2's D-lambda compute over 4 scenes, P3's euclidean matrix."""
    import torchmetrics_tpu_torch.image as ti
    from torchmetrics_tpu_torch.functional import pairwise_euclidean_distance

    sizes = chip_smoke.P_SIZES
    d1 = chip_smoke.path_p1_data(dict(sizes, p1_images=sizes["p1_batch"]))
    d2, d3 = chip_smoke.path_p2_data(sizes), chip_smoke.path_p3_data(sizes)
    rgb = [tuple(torch.from_numpy(d1[k]).to(device) for k in ("preds", "target"))] * (5 + STEPS)
    bands = [torch.from_numpy(d2[k]).to(device) for k in ("preds", "target")]
    x, y = (torch.from_numpy(d3[k]).to(device) for k in ("x", "y"))
    for tier in TIERS:
        with chip_smoke.tier(tier):
            for label, m in (("StructuralSimilarityIndexMeasure(data_range=1.0)", ti.StructuralSimilarityIndexMeasure(data_range=1.0)),
                             ("MultiScaleStructuralSimilarityIndexMeasure", ti.MultiScaleStructuralSimilarityIndexMeasure()),
                             ("PeakSignalNoiseRatio", ti.PeakSignalNoiseRatio()),
                             ("VisualInformationFidelity", ti.VisualInformationFidelity())):
                m.fast_update = True
                profile_path(card, f"path P1 {label} update (8 x 3 x 512 x 768), {tier} tier", m.update, rgb)
            dl = ti.SpectralDistortionIndex(p=1)
            dl.update(*bands)
            profile_path(card, f"path P2 SpectralDistortionIndex compute (4 x 31 x 512 x 512, 465 band pairs), {tier} tier",
                         lambda: chip_smoke._fresh_compute(dl), [()] * (5 + STEPS))
            del dl
            profile_path(card, f"path P3 pairwise_euclidean_distance (8,192 x 768 against 8,192), {tier} tier",
                         pairwise_euclidean_distance, [(x, y)] * (5 + STEPS))


def profile_q(device, card: str) -> None:
    """Path Q at its full widths, one step a call, each on both tiers: FID's update of 500 x 2048 features
    and its float64 compute over 50,000 + 50,000, KID's compute over the same features (100 subsets of
    1,000), SDR's update over 100 WSJ0-2mix-sized mixtures (2 x 32,000 samples, ``filter_length=512``,
    on the graph tier through ``fast_update``)."""
    import torchmetrics_tpu_torch.audio as ta
    import torchmetrics_tpu_torch.image as ti

    sizes = chip_smoke.Q_SIZES
    d1 = chip_smoke.path_q1_data(sizes)
    real, fake = (torch.from_numpy(d1[k]).to(device) for k in ("real", "fake"))
    b = sizes["q1_batch"]
    d3 = chip_smoke.path_q3_data(dict(sizes, q3_mixtures=sizes["q3_batch"], srmr_utterances=1))
    mixtures = [tuple(torch.from_numpy(d3[k]).to(device) for k in ("preds", "target"))] * (5 + STEPS)
    for tier in TIERS:
        with chip_smoke.tier(tier):
            fid = ti.FrechetInceptionDistance(feature=None, num_features=sizes["q1_dim"])
            profile_path(card, f"path Q1 FrechetInceptionDistance update (500 x 2048 features), {tier} tier", fid.update,
                         [(real[i:i + b],) for i in range(0, (5 + STEPS) * b, b)])
            for i in range(0, len(real), b):
                fid.update(real[i:i + b], real=True)
                fid.update(fake[i:i + b], real=False)
            profile_path(card, f"path Q1 FrechetInceptionDistance compute (float64, d = 2048), {tier} tier",
                         lambda: chip_smoke._fresh_compute(fid), [()] * (5 + STEPS), steps=5)
            del fid
            kid = ti.KernelInceptionDistance(feature=None, seed=73)
            for i in range(0, len(real), b):
                kid.update(real[i:i + b], real=True)
                kid.update(fake[i:i + b], real=False)
            profile_path(card, f"path Q1 KernelInceptionDistance compute (100 subsets of 1,000 x 2048), {tier} tier",
                         lambda: chip_smoke._fresh_compute(kid), [()] * (5 + STEPS), steps=5)
            del kid
            sdr = ta.SignalDistortionRatio(filter_length=sizes["sdr_filter"])
            sdr.fast_update = True
            profile_path(card, f"path Q3 SignalDistortionRatio update (100 x 2 x 32,000, filter 512), {tier} tier",
                         sdr.update, mixtures)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--l2-rank":  # one rank of path L2's profile, started by profile_l
        sys.exit(l2_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
