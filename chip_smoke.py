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
17. path M, clustering and nominal association on K1, on both tiers: M1, the nine extrinsic classes
    (50 ``update`` calls of 1,000, one ``compute``) and the ten extrinsic functional entries over
    ImageNet-1k validation's 50,000 labels, 1,000 classes against 1,000 clusters agreeing on 60%
    (seed 31), and the nine classes over a stream of 1,000,000 labels in 100 clusters (100 updates of
    10,000, seed 32), where the JAX package's float32 expected mutual information is 3.6 times off:
    contingency tables equal ``np.bincount``'s, every value float64 numpy's (the EMI a vectorised
    scipy ``gammaln`` sum of about 1e8 terms) within 1e-5 relative or a float32 bound; M2,
    ``CalinskiHarabaszScore``, ``DaviesBouldinScore`` and ``DunnIndex`` at p = 2 and p = 1 over
    50,000 float32 features of width 768 (a ViT-B/16 embedding of ImageNet validation, 154 MB) with
    1,000 k-means labels (seed 37), 50 updates of 1,000, against float64 numpy within 1e-5 or a
    float32 bound printed beside the error; M3, the four association classes at ``num_classes=1000``
    over 1,000,000 hashed click-log code pairs with 1% NaN (100 ``forward`` calls of 10,000, each
    NaN strategy; their confusion matrices equal numpy's counts), the four ``_matrix`` functionals
    over UCI Adult's eight categorical columns at 48,842 rows (seed 41) and ``FleissKappa`` over
    100,000 items, 10 categories and 5 raters in ``probs`` and ``counts`` mode. Each part must
    launch K1; its launches join the kernels line, and K2 and K3 must not launch. K1 is then timed
    at M1's contingency shape and M3's masked confusion shape (step 1 holds it to its plain version
    at path M's bincount shapes).
18. path N, the sketches, retrieval's sketch mode and the keyed engine, on both tiers: N1,
    ``StreamingQuantile(q=(0.1, 0.5, 0.99))`` over bench.py's quantile protocol (16 x 65,536 normals,
    seed 17, ``bench.py:788-811``) and ``StreamingQuantile(q=(0.5, 0.9, 0.99))`` over a serving
    dashboard's 100 x 65,536 lognormal(3, 1) request latencies (seed 51): rank error within
    ``kll.DEFAULT_RANK_ERROR`` against ``np.sort``, the count exact, the state the port's CPU run's bits,
    the halves' merge commutative bit for bit; ``StreamingHistogram(bins=64, lo=0, hi=2000)`` over the
    latencies (numpy's counts exactly, one K2 ``hist_pair`` launch an update); the count-min sketch
    (depth 4, width 1,024) over a click log's 100 x 100,000 Zipf(1.2) query ids in a vocabulary of 10^6
    (seed 53): numpy's uint32-hashed state exactly, one K1 launch an update, never under a true count,
    at least ``1 - e^-4`` of the ids within ``e·n/width``; N2, retrieval's ``approx="sketch"`` on path
    H's documents: query-aligned batches of 100 queries through the eight scalar classes and MAP's min
    and max (exact mode's values within 1e-5; the straddle count numpy's count-min simulation of the
    same batches: no query straddles, but 10,000 ids in 4 x 1,024 cells make the estimate count most),
    16 fixed batches of 65,536 through MAP (the straddle count at least numpy's cut queries and equal to
    its simulation, the warning given, numpy per fragment within 1e-5) and a ragged set in each empty action (``"error"`` raising at ``update``); N3, the keyed engine:
    bench.py's keyed protocol (``bench.py:258-300``, seed 11: ``KeyedMetric(SumMetric(nan_strategy=
    "ignore"), N)`` at N = 1,000, 10,000 and 100,000, 50 updates of 8,192 integers; numpy's sums exactly,
    updates/s), the mean, max and min at N = 10,000 (seed 55; float64 numpy within 1e-6 relative or the
    mean's float32 bound; max on the ``vmap`` strategy equal to segments; ``KeyedMetricCollection``), the
    per-advertiser ``KeyedMetric(BinaryAUROC(approx="sketch", sketch_bins=2048), 100)`` over 50 x 8,192
    scores (seed 57; each key's histogram pair a plain sketched metric's, values within 1e-6, one K2
    ``sketch_update`` launch an update through its vmap rule), ``KeyedMetric(StreamingHistogram(bins=64),
    1000)`` (one ``hist_pair`` launch an update) and ``KeyedMetric(StreamingQuantile(capacity=8), 64)`` on
    the ``vmap`` strategy over 10 x 256 (about 40 values a key, so every key compacts past level 1; each
    key bit-equal to an instance fed its values one at a time). The per-key references (the quantile's
    instances and the 100 plain sketched AUROCs) are built before the counts are set to 0, so N's K1 and
    K2 launches, which join the kernels line, are the main path's own; K3 must not launch. K1 is then
    timed at N1's count-min shape, K2's ``sketch_update`` at N3's vmap-rule shape and ``hist_pair`` at
    the keyed histogram's, each held first to its plain version at that shape, exactly.
19. path O, the online layer and the engine's telemetry, on both tiers, each with a fresh telemetry
    registry: O1, bench.py's online protocol at full size (``bench.py:1742-1871``, 256 batches of
    2,048 integers in [-6, 6], seed 29): updates/s of ``MeanMetric`` and ``Windowed(MeanMetric(), 8,
    advance_every=8)`` and their ratio beside JAX's stated bound 1.5, a manual ``advance`` and a
    ``KsDrift`` evaluation timed, the window value bit-equal to a fresh ``MeanMetric`` fed the window's
    batches through ``update``, ``buffered(4)`` and ``update_batches``, and a one-spec ``DriftMonitor``
    quiet over 10 stationary batches and firing once, with one warning, over 10 shifted by +4; O2, a
    CTR model's live quality (240 x 65,536 (score, click) pairs, seed 61):
    ``Windowed(BinaryAUROC(approx="sketch", sketch_bins=2048), 12, advance_every=10)`` (one K2
    ``sketch_update`` an update, the merged histogram pair numpy's bucket counts, the value a fresh
    sketch's bits, 24 emitted points) and ``Ema(BinaryAUROC(thresholds=200), decay=0.99)`` (one K3 launch
    an update, the confmat within the float32 bound of numpy's decayed counts, the value within 1e-5);
    O3, an image classifier's sliding top-1 (240 x 8,192 labels at 1,000 classes, seed 63):
    ``Windowed(MulticlassAccuracy(num_classes=1000), 12, 10)`` (one K1 launch an update, numpy's window
    counts exactly, the value within 1e-6) and its ``Ema`` (float32 states within the float32 bound of
    numpy's decayed counts, none truncated); O4, latency drift: path N1's lognormal(3, 1) latencies,
    60 x 65,536, then 40 batches of lognormal(3.5, 1) (seed 65) through ``Windowed(StreamingQuantile(q=
    (0.5, 0.9, 0.99)), 12, 5)`` watched by ``DriftMonitor(default_drift_specs(...))`` against the first
    10 batches (KS 0.1 and PSI 0.05 quiet before the shift and each firing once after it, the stock
    KS 0.15 and PSI 0.25 in the same monitor quiet throughout, the counters what the verdicts imply),
    the window's KLL state the stacked merge of its sub-windows' sketches bit for bit, the host
    KS within 1e-6 of ``kll_ks_distance`` on the card, a windowed ``StreamingHistogram`` (one K2
    ``hist_pair`` an update, numpy's counts) and an EWMA band over the emitted p99; O5, path A's
    collection under ``obs.enabled()``: the leader's calls, captures and retrace, dispatches equal to
    the graph replays, one span a call, and path A's graph step with telemetry off and on, 13 host aten
    operations either way, as before the hooks. Path O's launches join the kernels line.
20. path P, the pairwise distances and the image-quality metrics at full width, no kernel on it (K1-K3
    must launch 0 times): P1 at the Kodak set's shape (24 images of 3 x 512 x 768 in 3 batches of 8,
    seed 67: targets a sigma-4 blurred normal field rescaled to [0, 1], preds ``clip(target + 0.05 N)``):
    SSIM (``data_range=1.0``), MS-SSIM (default betas, ``normalize="relu"``), PSNR with ``data_range=None``
    and with ``dim=(1, 2, 3)``, UQI, VIF, TV of the preds, RMSE-SW (window 8), ``image_gradients`` (numpy's
    float32 differences exactly) and PSNR-B on each image's luma; P2 at CAVE's shape (4 scenes of 31 x 512
    x 512 in 2 batches, seed 69, bands sharing a scene field, 2% multiplicative noise): SAM, ERGAS
    (``ratio=4``), RASE (window 8), D-lambda (``p=1``, all 465 band pairs, in blocks of at most 1 GiB;
    each pair's two UQIs held to float64 within 1e-5, and D within the bound their errors imply); P3 at BERT-base's width (seed 71): cosine, euclidean and linear
    over 8,192 x 768 rows against 8,192 and alone, euclidean's ``reduction="mean"``, manhattan and minkowski
    (``exponent=3``) over 4,096 x 4,096 x 768 (blocks of rows of at most 1 GiB). Every value is held to a
    float64 numpy/scipy evaluation computed in host threads: SSIM, MS-SSIM, UQI and VIF within 1e-4
    absolute, PSNR and PSNR-B within 1e-4 relative, the rest within 1e-5 relative or a derived float32
    bound printed beside the error (P3 on 256 sampled rows of each matrix, the mean on every row). The
    scalar-state classes update through ``fast_update`` (one graph replay an update); P runs on the graph
    tier, on the eager tier, then on the graph tier again with the caller's ``allow_tf32`` set True for
    cuBLAS and cuDNN: all three bit-equal, and the flags read True afterwards. Each metric prints its wall
    per update (and the first update's, which captures), per compute, its peak device memory and its worst
    error against what it was allowed; P prints its total seconds.
21. path Q, the generative image metrics and the audio domain at full width, no kernel on it (K1-K3 must
    launch 0 times), through seeded stand-in networks built in-process (no weights are downloaded): Q1
    (seed 73) FID-50k in raw-feature mode (50,000 real and 50,000 generated 2048-d features in batches of
    500, a shifted mean and a covariance scaled by 1.15), held to ``np.cov`` and the two-eigh formula in
    float64 within a first-order bound of its float32 batch Gram matrices, to numpy's formula on its own
    states within 4u, with the float32 formula's (JAX's) error printed beside it and the formula checked
    against ``scipy.linalg.sqrtm`` at d = 256; the extractor route (4 batches of 64 uint8 images of 3 x
    299 x 299 through a stand-in CNN, and with ``normalize=True`` on [0, 1] floats) bit-equal to
    raw-feature mode on the same features; KID at the reference's defaults (100 subsets of 1,000) over
    ``RandomState(73)``'s subsets; IS over 50,000 x 1,008 logits, ``splits=10``; MiFID, 10,000 generated
    against 20,000 real, 8,000 near-copies putting the distance under ``eps``; Q2 (seed 75) LPIPS through
    an AlexNet-shaped stand-in at 3 x 256 x 256, 8 batches of 16, and PPL over 10,000 latents of a
    stand-in generator (512-d to 3 x 256 x 256) in batches of 64, lerp and ``slerp_unit``, its kept
    distances exactly numpy's float64 discards of the same distances; Q3 (seed 79) 3,000 two-speaker
    mixtures at 8 kHz cut to 4 s in batches of 100 through PIT (SI-SNR, speaker-wise), SI-SDR, SNR,
    SA-SDR, C-SI-SNR on 512-point STFTs (hop 128), SDR (``filter_length=512``) over the first 200 against
    ``scipy.linalg.solve_toeplitz``, each within its first-order float32 bound of float64 numpy and
    captured once, then replayed, on the graph tier; and SRMR over 64 utterances of 4 s at 16 kHz, a host
    float64 pipeline by design, its wall printed. Each metric prints its wall per update and compute, its
    peak device memory, its error against what it was allowed, and its graph captures, replays and
    fallbacks with their reasons (the generative classes keep JAX's ``jit_update = False``).

22. path R, the text metrics that need no model, on both tiers, no kernel on it (K1-K3 must launch 0 times),
    over seeded stand-in text (no corpus is downloaded): R1 at WMT14 En-De newstest2014's size (3,003
    segments, one reference each, seed 83; a Zipf vocabulary of 32,000 word types with punctuation,
    lognormal reference lengths of mean 25 words, hypotheses by word edits and one phrase moved a segment):
    BLEU-4, SacreBLEU ``13a``, chrF and chrF++ with sentence scores, TER and EED (over the first 1,024
    segments) in updates of 64, and SacreBLEU ``char`` and ``zh`` over 300 segments with CJK ideographs; R2 at LibriSpeech test-clean's size
    (2,620 upper-case utterances, 5% word edits, seed 85): WER, CER, MER, WIL, WIP and ``EditDistance`` over
    characters and over words, ``substitution_cost`` 1 and 2, ``reduction`` ``mean`` and ``none``; R3 (seed
    87) ``SQuAD`` over SQuAD v1.1 dev's 10,570 questions and ``ROUGEScore`` (``rouge1``, ``rouge2``,
    ``rougeL``, ``rougeLsum`` through the regex split) over CNN/DailyMail test's 11,490 multi-sentence
    pairs; R4 ``Perplexity`` at GPT-2's width (V = 50,257, context 1,024, batches of 8: 1.65 GB of float32
    logits an update, drawn on the card) over 280 windows, with ``ignore_index=None`` and under the stride-512
    protocol with ``ignore_index=-100``. Oracles, computed in worker processes while the tiers run: every
    R2 distance equal to a plain integer DP exactly; BLEU and chrF within 1e-6 of plain ``Counter`` passes;
    TER, EED, SQuAD and ROUGE within the float32 rounding of their batch sums of the functional over the
    whole set; Perplexity within its first-order float32 bound (or 1e-5) of a float64 evaluation on the
    card, itself held to numpy on the first window. R1 and R3 run on the eager tier over their first 512
    items, held bit-equal to the graph tier's value after as many (the ``reduced`` line). Each metric prints
    its wall per update (the first apart) and compute, its peak memory and its tier's captures and fallbacks;
    the row scan's device operations and time for one CER update; one Perplexity update's device time
    against its bytes bound, with the static-input copy's share on the graph tier.
23. path S, the encoder-backed metrics, on both tiers, no kernel on it (K1-K3 must launch 0 times), through
    seeded stand-in models in plain ``torch.nn`` at the published widths, in bfloat16 inside, float32 out (no
    weights or tokenizer files are downloaded; the machine with the card has no transformers): S1
    ``BERTScore(num_layers=17)`` through a roberta-large-wide encoder (24 layers, d = 1,024, 16 heads, FFN
    4,096, vocabulary 50,265, a word-hash tokenizer with ``<s>``/``</s>`` masked as special) over WMT16
    En-De newstest2016's 2,999 stand-in pairs (R1's generator, seed 89) in updates of 64, with ``idf=False``,
    ``idf=True`` and ``all_layers=True`` (a layer-stacked encoder, a 25-row baseline csv; over the first 64
    pairs); S2 ``InfoLM(idf=True, temperature=0.25)`` through a bert-base-wide masked LM (12 layers, d = 768,
    V = 30,522, ``max_length`` 20: 20 masked passes a batch) over the first 1,000 pairs, all nine measures on
    the same distributions; S3 ``CLIPScore`` through ViT-L/14-wide towers (image: 224 x 224 in 14-pixel
    patches, 24 layers, d = 1,024; text: 12 layers, d = 768, 77 tokens; projection 768) over 5,000 seeded
    uint8 images with one caption each (the COCO Karpathy test split's size) in updates of 64; S4
    ``CLIPImageQualityAssessment`` over 2,015 images in [0, 1] (KonIQ-10k's test split) with three prompt
    pairs. Oracles in float64 on what the encoders returned: BERTScore's greedy matching (every layer with
    ``all_layers``) within 1e-5; each InfoLM measure within its first-order float32 bound; CLIP's scores
    within 1e-5 (the score sum within its float32 bound). It prints each wall per update and compute and one
    batch's matching against its bytes bound.
24. path T, detection, on both tiers, no kernel on it (K1-K3 must launch 0 times): T1 at COCO val2017's size
    (5,000 images, 80 classes, 36,781 ground-truth boxes in COCO's area mix with 1% ``iscrowd``, 100
    detections an image, seed 91): ``MeanAveragePrecision`` with ``class_metrics=True`` and with
    ``average="micro"`` (thresholds 0.50:0.05:0.95, 101 recall points, max detections 1, 10, 100) in updates
    of 64, and the four IoU classes over the same boxes; T2 ``iou_type=("bbox", "segm")`` over the first 200
    images at 480 x 640 with seeded polygon masks; T3 ``PanopticQuality`` and ``ModifiedPanopticQuality`` over
    5,000 panoptic maps at 480 x 640 (COCO panoptic's 80 things and 53 stuffs, drawn on the card) in updates of
    16. Oracles, in worker processes while the tiers run: a plain per-group greedy matcher written from the
    COCO protocol, whose match tables the port's must equal exactly, with its own accumulation, within 1e-6
    on every summary number; the IoU classes against float64 corner algebra within 1e-6; panoptic quality's
    class over the first 500 images bit-equal to the functional over them at once, and its sums over the
    first 50 images equal to a plain per-segment evaluation. It prints each wall per update and compute, the
    matcher's device time, operations and peak memory on each tier, and the mask product's device time
    against its FLOP bound.

Paths A and C-T run on the graph tier (``ops/dispatch.py``: each fused step one captured CUDA
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

import hashlib
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
    # path M's bincounts: M1's two contingency tables, M2's cluster sizes, M3's Fleiss counts
    for n, length in ((50_000, 1_000_000), (1_000_000, 10_000), (50_000, 1000), (5000, 10_000)):
        x = torch.from_numpy(gen.randint(0, length, n)).to(device)
        check(f"bincount path M n={n} length={length}", k1.bincount(x, length, out), k1.bincount_plain(x, length, out))
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


# ---------------------------------------------------------------------------------------------
# Path M: clustering and nominal association, on K1
M_TOL = 1e-5
#: path M's full sizes; the tests pass smaller ones
M_SIZES = {"m1_rows": 50_000, "m1_classes": 1000, "m1_batch": 1000, "m1_stream_rows": 1_000_000, "m1_stream_classes": 100,
           "m1_stream_batch": 10_000, "m2_rows": 50_000, "m2_dim": 768, "m2_clusters": 1000, "m2_batch": 1000,
           "m3_pairs": 1_000_000, "m3_classes": 1000, "m3_batch": 10_000, "m3_adult_rows": 48_842, "m3_items": 100_000,
           "m3_item_batch": 1000}
#: UCI Adult's eight categorical columns, by their cardinalities: workclass, education, marital status,
#: occupation, relationship, race, sex, native country
ADULT_CARDINALITIES = (9, 16, 7, 15, 6, 5, 2, 42)
#: the extrinsic classes and the keys of their float64 values in ``extrinsic_np``
M1_CLASSES = {"MutualInfoScore": "mutual_info", "RandScore": "rand", "AdjustedRandScore": "adjusted_rand",
              "AdjustedMutualInfoScore": "adjusted_mutual_info", "NormalizedMutualInfoScore": "normalized_mutual_info",
              "FowlkesMallowsIndex": "fowlkes_mallows", "HomogeneityScore": "homogeneity",
              "CompletenessScore": "completeness", "VMeasureScore": "v_measure"}
#: the association classes and their functional forms
M3_CLASSES = {"CramersV": "cramers_v", "TschuprowsT": "tschuprows_t",
              "PearsonsContingencyCoefficient": "pearsons_contingency_coefficient", "TheilsU": "theils_u"}


def path_m1_labels(rows: int, classes: int, seed: int):
    """Cluster ids against true classes, agreeing on 60% of samples: a clustering of ``rows`` samples
    whose cluster ids are a permutation of the classes, the rest at random. int64 numpy arrays."""
    rng = np.random.RandomState(seed)
    target = rng.randint(0, classes, rows)
    perm = rng.permutation(classes)
    preds = np.where(rng.rand(rows) < 0.6, perm[target], rng.randint(0, classes, rows))
    return preds.astype(np.int64), target.astype(np.int64)


def contingency_np(preds: np.ndarray, target: np.ndarray) -> np.ndarray:
    """int64 ``(R, C)`` table of the sorted label codes, by ``np.bincount``."""
    _, t = np.unique(target, return_inverse=True)
    _, p = np.unique(preds, return_inverse=True)
    cols = int(p.max()) + 1
    return np.bincount(t.ravel() * cols + p.ravel(), minlength=(int(t.max()) + 1) * cols).reshape(-1, cols)


def emi_np(a: np.ndarray, b: np.ndarray, n: int, chunk: int = 1 << 23) -> float:
    """sklearn's expected mutual information in float64: every ``(i, j, nij)`` term of its valid range,
    the ``gammaln`` terms from one scipy table of ``gammaln(k + 1)``, summed by numpy in chunks of
    about ``chunk`` terms (about 1e8 terms at 1,000,000 samples and 100 clusters)."""
    from scipy.special import gammaln

    lg = gammaln(np.arange(n + 1, dtype=np.float64) + 1)
    ai, bj = np.repeat(a, len(b)), np.tile(b, len(a))
    lo = np.maximum(1, ai + bj - n)
    count = np.maximum(np.minimum(ai, bj) - lo + 1, 0)
    keep = count > 0
    ai, bj, lo, count = ai[keep], bj[keep], lo[keep], count[keep]
    const = lg[ai] + lg[bj] + lg[n - ai] + lg[n - bj] - lg[n]
    log_const = np.log(n) - np.log(ai) - np.log(bj)
    ends = np.cumsum(count)
    total, first = 0.0, 0
    while first < len(count):
        stop = max(int(np.searchsorted(ends, ends[first] - count[first] + chunk, side="right")), first + 1)
        cc = count[first:stop]
        cell = np.repeat(np.arange(first, stop), cc)
        nij = lo[cell] + np.arange(int(cc.sum())) - np.repeat(np.cumsum(cc) - cc, cc)
        a_c, b_c = ai[cell], bj[cell]
        gln = const[cell] - lg[nij] - lg[a_c - nij] - lg[b_c - nij] - lg[n - a_c - b_c + nij]
        x = nij.astype(np.float64)
        total += float(np.sum(x / n * (log_const[cell] + np.log(x)) * np.exp(gln)))
        first = stop
    return total


def extrinsic_np(table: np.ndarray) -> dict:
    """The nine extrinsic scores (``average_method="arithmetic"``, ``beta=1``) and the EMI in float64
    from a contingency table, with the first-order float32 error bounds of the MI-based scores, which
    the port sums in float32 over the whole ``(R, C)`` grid: each sum within ``g * Σ|term|``,
    ``g = (ceil(log2 cells) + K_SERIAL + 6) u``. The pair counts are exact integers."""
    n = int(table.sum())
    a, b = table.sum(1), table.sum(0)
    nz = table > 0
    c = table[nz].astype(np.float64)
    ai = np.broadcast_to(a[:, None], table.shape)[nz].astype(np.float64)
    bj = np.broadcast_to(b[None, :], table.shape)[nz].astype(np.float64)
    mi_terms = c / n * (np.log(n) + np.log(c) - np.log(ai) - np.log(bj))
    mi = float(mi_terms.sum())
    h_terms = [-(x / n) * np.log(x / n) for x in (a.astype(np.float64), b.astype(np.float64))]
    h_t, h_p = (float(h.sum()) for h in h_terms)
    emi = emi_np(a, b, n)
    sum_sq = int((table.astype(np.int64) ** 2).sum())
    m11 = sum_sq - n
    m10 = int((table.astype(np.int64) * b[None, :]).sum()) - sum_sq
    m01 = int((table.astype(np.int64).T * a[None, :]).sum()) - sum_sq
    m00 = n * n - m01 - m10 - sum_sq
    tn, fp, fn, tp = m00, m01, m10, m11
    pk, qk = int((b.astype(np.int64) ** 2).sum()) - n, int((a.astype(np.int64) ** 2).sum()) - n
    hom, comp = mi / h_t, mi / h_p
    mean_h = (h_t + h_p) / 2
    g = lambda cells: (int(np.ceil(np.log2(max(cells, 2)))) + K_SERIAL + 6) * U32  # noqa: E731
    d_mi = g(table.size) * float(np.abs(mi_terms).sum())
    d_ht, d_hp = g(len(a)) * float(np.abs(h_terms[0]).sum()), g(len(b)) * float(np.abs(h_terms[1]).sum())
    d_emi = U32 * emi
    d_hom, d_comp = (d_mi + hom * d_ht) / h_t, (d_mi + comp * d_hp) / h_p
    ami = (mi - emi) / (mean_h - emi)
    return {
        "mutual_info": mi, "mutual_info_bound": d_mi,
        "rand": (m00 + m11) / (m00 + m01 + m10 + m11),
        "adjusted_rand": 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn)),
        "adjusted_mutual_info": ami,
        "adjusted_mutual_info_bound": (d_mi + d_emi + abs(ami) * ((d_ht + d_hp) / 2 + d_emi)) / (mean_h - emi),
        "normalized_mutual_info": mi / mean_h,
        "normalized_mutual_info_bound": (d_mi + mi / mean_h * (d_ht + d_hp) / 2) / mean_h,
        "fowlkes_mallows": float(np.sqrt(m11 / pk) * np.sqrt(m11 / qk)),
        "homogeneity": hom, "homogeneity_bound": d_hom, "completeness": comp, "completeness_bound": d_comp,
        "v_measure": 2 * hom * comp / (hom + comp),
        "v_measure_bound": (2 * comp**2 * d_hom + 2 * hom**2 * d_comp) / (hom + comp) ** 2,
        "expected_mutual_info": emi,
    }


def _m_check(name: str, got, want: dict, key: str) -> float:
    return check_rel(name, got, want[key], M_TOL, want.get(key + "_bound", 0.0))


def run_path_m1(device, tier_name: str, sizes: dict = M_SIZES, refs: dict = None):
    """M1, the extrinsic scores at full width on one tier: ImageNet-1k validation (``m1_rows`` labels,
    ``m1_classes`` classes and clusters, seed 31; the nine classes through 50 ``update`` calls, one
    ``compute`` each, then the ten functional entries on the whole arrays) and a stream of
    ``m1_stream_rows`` labels over ``m1_stream_classes`` clusters (seed 32, the nine classes through 100
    updates). The contingency tables equal ``np.bincount``'s; every value float64 numpy's within 1e-5
    relative, or the float32 bound of ``extrinsic_np``. ``refs`` carries the numpy side from the first
    tier to the second. Returns (values for the tier comparison, {name: line}, refs, errors)."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.functional import clustering as fc
    from torchmetrics_tpu_torch.functional.clustering.utils import calculate_contingency_matrix
    from torchmetrics_tpu_torch.ops.dispatch import STATS

    datasets = {"ImageNet-1k val": (sizes["m1_rows"], sizes["m1_classes"], sizes["m1_batch"], 31),
                "stream": (sizes["m1_stream_rows"], sizes["m1_stream_classes"], sizes["m1_stream_batch"], 32)}
    if refs is None:
        refs = {}
        for label, (rows, classes, _, seed) in datasets.items():
            preds, target = path_m1_labels(rows, classes, seed)
            table = contingency_np(preds, target)
            refs[label] = (preds, target, table, extrinsic_np(table))
    values, lines, errors = {}, {}, {}
    for label, (rows, classes, batch, _) in datasets.items():
        preds, target, table, want = refs[label]
        p, t = torch.from_numpy(preds).to(device), torch.from_numpy(target).to(device)
        got = calculate_contingency_matrix(p, t)
        if not np.array_equal(got.cpu().numpy(), table):
            raise AssertionError(f"path M1 {label}: the contingency table differs from np.bincount's")
        walls, worst = {}, 0.0
        before = dict(STATS.fallbacks)
        for name, key in M1_CLASSES.items():
            m = getattr(tm, name)(device=device)
            m.fast_update = True  # asked for the update-only graph tier; the list states keep it eager
            for i in range(rows // batch):
                m.update(p[i * batch:(i + 1) * batch], t[i * batch:(i + 1) * batch])
            sync()
            t0 = time.perf_counter()
            value = m.compute()
            sync()
            walls[name] = (time.perf_counter() - t0) * 1e3
            errors[f"{label} {name}"] = _m_check(f"path M1 {label} {name}", value, want, key)
            worst = max(worst, errors[f"{label} {name}"] / abs(want[key]))
            values[f"{label} {name}"] = _bits(value)
        fallbacks = {k: v - before.get(k, 0) for k, v in STATS.fallbacks.items() if v != before.get(k, 0)}
        if tier_name == "graph" and {k[1:] for k in fallbacks} != {("update", "jit_update_off")}:
            raise AssertionError(f"path M1 {label}: fallbacks {fallbacks}; only the list states' eager updates expected")
        line = (f"{rows:,} labels, {table.shape[0]} classes x {table.shape[1]} clusters, {rows // batch} updates of"
                f" {batch:,} then compute; compute wall ms " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
        if label == "ImageNet-1k val":
            funcs = {}
            for name in ("mutual_info_score", "rand_score", "adjusted_rand_score", "adjusted_mutual_info_score",
                         "normalized_mutual_info_score", "fowlkes_mallows_index", "homogeneity_score",
                         "completeness_score", "v_measure_score"):
                funcs[name] = getattr(fc, name)(p, t)
            funcs["expected_mutual_info_score"] = fc.expected_mutual_info_score(got, rows)
            for (name, value), key in zip(funcs.items(), list(M1_CLASSES.values()) + ["expected_mutual_info"]):
                errors[f"{label} {name}"] = _m_check(f"path M1 {label} {name}", value, want, key)
                worst = max(worst, errors[f"{label} {name}"] / abs(want[key]))
                values[f"{label} {name}"] = _bits(value)
            line += "; the ten functional entries on the whole arrays agree"
        sync()
        t0 = time.perf_counter()
        emi = fc.expected_mutual_info_score(got, rows)
        sync()
        line += (f"; EMI {float(emi):.7g} (float64 numpy {want['expected_mutual_info']:.7g}) in"
                 f" {(time.perf_counter() - t0) * 1e3:.3f} ms; max relative error against float64 {worst:.3g}")
        lines[label] = line
    return values, lines, refs, errors


def path_m2_data(rows: int, dim: int, clusters: int, seed: int = 37):
    """Image embeddings and their k-means labels: ``rows`` float32 vectors of width ``dim`` (a
    ViT-B/16 embedding of ImageNet validation at full size, 154 MB), each its cluster's centre plus
    noise of half the centres' spread; the label is the cluster's id (seed 37)."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((clusters, dim), dtype=np.float32)
    labels = rng.integers(0, clusters, rows)
    data = centres[labels] + np.float32(0.5) * rng.standard_normal((rows, dim), dtype=np.float32)
    return data, labels.astype(np.int64)


def intrinsic_np(data: np.ndarray, labels: np.ndarray) -> dict:
    """Calinski-Harabasz, Davies-Bouldin and Dunn (p = 2 and p = 1) in float64, and their first-order
    float32 error bounds. The port sums each cluster's ``m`` rows in order, so a centroid component
    is within ``(m + 1) u`` of the mean of ``|x|`` over its rows; a distance over ``d`` components of
    float32 differences within ``(d + 3) u`` of itself beyond the errors of its ends; ``torch.sum``
    of ``N`` terms within ``(ceil(log2 N) + K_SERIAL) u`` of their sum."""
    from scipy.spatial.distance import cdist

    u = U32
    x = data.astype(np.float64)
    n, d = x.shape
    k = int(labels.max()) + 1
    counts = np.bincount(labels, minlength=k).astype(np.float64)
    order = np.argsort(labels, kind="stable")
    starts = np.r_[0, np.cumsum(counts)[:-1]].astype(np.int64)
    centroids = np.add.reduceat(x[order], starts, axis=0) / counts[:, None]
    c_abs = np.add.reduceat(np.abs(x[order]), starts, axis=0) / counts[:, None]
    g_c = (counts + 1) * u  # per cluster
    dc2 = g_c * np.linalg.norm(c_abs, axis=1)
    dc1 = g_c * np.abs(c_abs).sum(1)
    mean = x.mean(0)
    dev = x - centroids[labels]
    row2 = np.sqrt((dev * dev).sum(1))
    row1 = np.abs(dev).sum(1)
    out = {}
    # Calinski-Harabasz
    within = float((row2 * row2).sum())
    between = float((counts * ((centroids - mean) ** 2).sum(1)).sum())
    d_mean = (np.ceil(np.log2(n)) + K_SERIAL + 1) * u * np.linalg.norm(np.abs(x).mean(0))
    d_within = float((2 * row2 * dc2[labels]).sum()) + (np.ceil(np.log2(n * d)) + K_SERIAL + 3) * u * within
    d_between = float((counts * 2 * np.linalg.norm(centroids - mean, axis=1) * (dc2 + d_mean)).sum()) \
        + (d + np.ceil(np.log2(k)) + K_SERIAL + 3) * u * between
    out["calinski_harabasz"] = between * (n - k) / (within * (k - 1))
    out["calinski_harabasz_bound"] = out["calinski_harabasz"] * (d_between / between + d_within / within + 2 * u)
    # Davies-Bouldin
    cd = cdist(centroids, centroids)
    intra = np.bincount(labels, weights=row2, minlength=k) / counts
    d_intra = dc2 + (d + 3 + counts + 1) * u * intra
    d_cd = dc2[:, None] + dc2[None, :] + (d + 3) * u * cd
    np.fill_diagonal(cd, np.inf)
    ratio = (intra[:, None] + intra[None, :]) / cd
    d_ratio = (d_intra[:, None] + d_intra[None, :]) / cd + ratio * (d_cd / cd + 2 * u)
    out["davies_bouldin"] = float(ratio.max(1).mean())
    out["davies_bouldin_bound"] = float(d_ratio.max(1).mean()) + (np.ceil(np.log2(k)) + K_SERIAL) * u * out["davies_bouldin"]
    # Dunn, p = 2 and p = 1
    for p, dist, row, dc in ((2, cd, row2, dc2), (1, cdist(centroids, centroids, "cityblock"), row1, dc1)):
        np.fill_diagonal(dist, np.inf)
        inter, intra_max = float(dist.min()), float(row.max())
        d_inter = 2 * float(dc.max()) + (d + 3) * u * inter
        d_intra_max = float(dc.max()) + (d + 3) * u * intra_max
        value = inter / intra_max
        out[f"dunn_p{p}"] = value
        out[f"dunn_p{p}_bound"] = value * (d_inter / inter + d_intra_max / intra_max + u)
    return out


M2_CLASSES = {"CalinskiHarabaszScore": ({}, "calinski_harabasz"), "DaviesBouldinScore": ({}, "davies_bouldin"),
              "DunnIndex": ({"p": 2}, "dunn_p2"), "DunnIndex p=1": ({"p": 1}, "dunn_p1")}


def run_path_m2(device, tier_name: str, data, want: dict, batch: int = 1000):
    """M2, the intrinsic scores on one tier: ``CalinskiHarabaszScore``, ``DaviesBouldinScore`` and
    ``DunnIndex`` at p = 2 and p = 1 through ``rows // batch`` updates and one compute each, then the
    three functional entries (Dunn at both ``p``) on the whole arrays, bit-equal to the classes; each
    value float64 numpy's within 1e-5 relative, or ``intrinsic_np``'s float32 bound. ``data`` is the
    ``(features, labels)`` pair on ``device``. Returns (values, line, errors)."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.functional import clustering as fc
    from torchmetrics_tpu_torch.ops.dispatch import STATS

    x, labels = data
    rows = x.shape[0]
    values, errors, walls, peaks = {}, {}, {}, {}
    before = dict(STATS.fallbacks)
    for name, (kwargs, key) in M2_CLASSES.items():
        m = getattr(tm, name.split(" ")[0])(device=device, **kwargs)
        m.fast_update = True
        for i in range(rows // batch):
            m.update(x[i * batch:(i + 1) * batch], labels[i * batch:(i + 1) * batch])
        sync()
        if x.is_cuda:
            torch.cuda.reset_peak_memory_stats(x.device)
            held = torch.cuda.memory_allocated(x.device)
        t0 = time.perf_counter()
        value = m.compute()
        sync()
        walls[name] = (time.perf_counter() - t0) * 1e3
        if x.is_cuda:
            peaks[name] = (torch.cuda.max_memory_allocated(x.device) - held) / 2**30
        errors[name] = check_rel(f"path M2 {name}", value, want[key], M_TOL, want[key + "_bound"])
        values[name] = _bits(value)
        functional = {"calinski_harabasz": fc.calinski_harabasz_score, "davies_bouldin": fc.davies_bouldin_score,
                      "dunn_p2": lambda a, b: fc.dunn_index(a, b, 2), "dunn_p1": lambda a, b: fc.dunn_index(a, b, 1)}[key]
        if _bits(functional(x, labels)) != values[name]:
            raise AssertionError(f"path M2 {name}: the functional entry on the whole arrays differs from the class")
    fallbacks = {k: v - before.get(k, 0) for k, v in STATS.fallbacks.items() if v != before.get(k, 0)}
    if tier_name == "graph" and {k[1:] for k in fallbacks} != {("update", "jit_update_off")}:
        raise AssertionError(f"path M2: fallbacks {fallbacks}; only the list states' eager updates expected")
    line = (f"{rows:,} x {x.shape[1]} float32 features, {rows // batch} updates of {batch:,}; compute wall ms "
            + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
            + ("" if not peaks else "; peak GiB beyond the state " + ", ".join(f"{k} {v:.3f}" for k, v in peaks.items()))
            + "; errors (bound) " + ", ".join(f"{k} {errors[k]:.3g} ({want[M2_CLASSES[k][1] + '_bound']:.3g})" for k in errors))
    return values, line, errors


def path_m3_pairs(pairs: int, classes: int, seed: int = 39):
    """A hashed feature pair of a click log: two categorical columns hashed into ``classes`` buckets,
    the second a function of the first for 30% of rows, each NaN on 1% of rows (float32 codes)."""
    rng = np.random.RandomState(seed)
    x = np.minimum(rng.zipf(1.3, pairs), 10**9) * 2654435761 % classes
    y = np.where(rng.rand(pairs) < 0.3, (x * 7 + 3) % classes, rng.randint(0, classes, pairs))
    x, y = x.astype(np.float32), y.astype(np.float32)
    x[rng.rand(pairs) < 0.01] = np.nan
    y[rng.rand(pairs) < 0.01] = np.nan
    return x, y


def path_m3_adult(rows: int, seed: int = 41):
    """UCI Adult's eight categorical columns at its 48,842 rows, as synthetic codes of its
    cardinalities: each column follows a shared latent group on 40% of rows (seed 41)."""
    rng = np.random.RandomState(seed)
    latent = rng.randint(0, 64, rows)
    cols = [np.where(rng.rand(rows) < 0.4, latent % card, rng.randint(0, card, rows)) for card in ADULT_CARDINALITIES]
    return np.stack(cols, axis=1).astype(np.float32)


def nominal_np(preds: np.ndarray, target: np.ndarray, classes: int, nan_strategy: str) -> dict:
    """The ``(C, C)`` table of ``target`` rows and ``preds`` columns by ``np.bincount`` (a NaN
    replaced by 0 or its pair dropped, a code outside ``[0, C)`` dropped), and the four statistics in
    float64 over its non-empty rows and columns: Cramer's V and Tschuprow's T with bias correction,
    Pearson's coefficient, Theil's U of ``preds`` given ``target``."""
    p, t = preds.astype(np.float64), target.astype(np.float64)
    if nan_strategy == "replace":
        p, t = np.nan_to_num(p, nan=0.0), np.nan_to_num(t, nan=0.0)
    else:
        keep = ~(np.isnan(p) | np.isnan(t))
        p, t = p[keep], t[keep]
    p, t = p.astype(np.int64), t.astype(np.int64)
    ok = (p >= 0) & (p < classes) & (t >= 0) & (t < classes)
    table = np.bincount(t[ok] * classes + p[ok], minlength=classes * classes).reshape(classes, classes)
    return {"table": table, **association_np(table, classes * classes)}


def association_np(table: np.ndarray, grid: int) -> dict:
    """Cramer's V and Tschuprow's T (bias-corrected), Pearson's coefficient and Theil's U of a
    contingency table in float64, its empty rows and columns dropped, each with the first-order
    bound of the port's float32 evaluation over a grid of ``grid`` cells: a sum within
    ``g = (ceil(log2 grid) + K_SERIAL + 6) u`` of ``Σ|term|``; a chi-square term ``(c - e)^2 / e``
    within ``6 u |c - e| + 5 u`` of itself (``e`` is three roundings); a log of a float32
    probability within ``2 u + u |log p|``."""
    u = U32
    g = (int(np.ceil(np.log2(max(grid, 2)))) + K_SERIAL + 6) * u
    c = table[table.sum(1) > 0][:, table.sum(0) > 0].astype(np.float64)
    n = c.sum()
    r, k = c.shape
    expected = c.sum(1)[:, None] * c.sum(0)[None, :] / n
    terms = (c - expected) ** 2 / expected
    chi2 = float(terms.sum())
    d_phi2 = (float((6 * u * np.abs(c - expected) + 5 * u * terms).sum()) + g * chi2) / n + u * chi2 / n
    phi2 = chi2 / n
    phi2_corr = max(0.0, phi2 - (r - 1) * (k - 1) / (n - 1))
    r_corr, k_corr = r - (r - 1) ** 2 / (n - 1), k - (k - 1) ** 2 / (n - 1)
    m, s = min(r_corr - 1, k_corr - 1), np.sqrt((r_corr - 1) * (k_corr - 1))
    cramers, tschuprows, pearson = np.sqrt(phi2_corr / m), np.sqrt(phi2_corr / s), np.sqrt(phi2 / (1 + phi2))
    p_xy = c / n
    p_x, p_y = c.sum(0) / n, c.sum(1) / n
    nz = p_xy > 0
    log_y = np.log(np.broadcast_to(p_y[:, None], c.shape)[nz])
    h_x = -float((p_x * np.log(p_x)).sum())
    h_x_given_y = float((p_xy[nz] * (log_y - np.log(p_xy[nz]))).sum())
    d_hx = (g + 4 * u) * float((p_x * np.abs(np.log(p_x))).sum()) + 4 * u
    d_hxy = (g + 4 * u) * float((p_xy[nz] * (np.abs(log_y) + np.abs(np.log(p_xy[nz])))).sum()) + 4 * u
    theils = (h_x - h_x_given_y) / h_x
    return {"cramers_v": min(1.0, cramers), "cramers_v_bound": d_phi2 / (2 * max(cramers, 1e-30) * m) + 2 * u * cramers,
            "tschuprows_t": min(1.0, tschuprows),
            "tschuprows_t_bound": d_phi2 / (2 * max(tschuprows, 1e-30) * s) + 2 * u * tschuprows,
            "pearsons_contingency_coefficient": pearson,
            "pearsons_contingency_coefficient_bound": d_phi2 / (2 * pearson * (1 + phi2) ** 2) + 2 * u * pearson,
            "theils_u": theils, "theils_u_bound": (d_hx + d_hxy + abs(theils) * d_hx) / h_x}


def fleiss_np(counts: np.ndarray) -> tuple:
    """Fleiss' kappa of a ``(subjects, categories)`` count table in float64, with the JAX package's
    ``1e-5`` in the denominator (``functional/nominal/fleiss_kappa.py:41``), and the first-order bound
    of the port's float32 evaluation: the counts and their squares are exact, the mean over subjects
    within ``(ceil(log2 N) + K_SERIAL + 3) u`` of the mean of ``|p_j|``, ``Σ p_i^2`` within
    ``(C + 4) u`` of itself."""
    c = counts.astype(np.float64)
    raters = c.sum(1).max()
    p_i = c.sum(0) / (c.shape[0] * raters)
    p_j = ((c**2).sum(1) - raters) / (raters * (raters - 1))
    p_bar, pe_bar = p_j.mean(), (p_i**2).sum()
    den = 1 - pe_bar + 1e-5
    kappa = (p_bar - pe_bar) / den
    d_bar = (np.ceil(np.log2(c.shape[0])) + K_SERIAL + 3) * U32 * np.abs(p_j).mean()
    d_pe = (c.shape[1] + 4) * U32 * pe_bar
    return float(kappa), float((d_bar + d_pe) / den + abs(kappa) * (d_pe / den + 2 * U32))


def path_m3_refs(sizes: dict = M_SIZES) -> dict:
    """M3's inputs and their numpy side: the click-log pair with each NaN strategy, UCI Adult's
    pairwise matrices, and a rating panel (100,000 items, 10 categories, 5 raters who each pick the
    item's true category on 60% of ratings; seed 43) as ``counts`` and as ``probs`` whose argmax is
    each rater's pick."""
    classes = sizes["m3_classes"]
    x, y = path_m3_pairs(sizes["m3_pairs"], classes)
    adult = path_m3_adult(sizes["m3_adult_rows"])
    v = adult.shape[1]
    matrices = {name: np.ones((v, v)) for name in M3_CLASSES.values()}
    bounds = {name: np.zeros((v, v)) for name in M3_CLASSES.values()}
    for i in range(v):
        for j in range(v):
            if i == j:
                continue
            stats = association_np(contingency_np(adult[:, i], adult[:, j]), len(np.union1d(adult[:, i], adult[:, j])) ** 2)
            for name in M3_CLASSES.values():
                matrices[name][i, j], bounds[name][i, j] = stats[name], stats[name + "_bound"]
    rng = np.random.RandomState(43)
    items = sizes["m3_items"]
    truth = rng.randint(0, 10, items)
    picked = np.where(rng.rand(items, 5) < 0.6, truth[:, None], rng.randint(0, 10, (items, 5)))
    probs = rng.rand(items, 10, 5).astype(np.float32)
    probs[np.arange(items)[:, None], picked, np.arange(5)[None, :]] += np.float32(1.0)
    counts = np.stack([(picked == cat).sum(1) for cat in range(10)], axis=1)
    return {"pairs": (x, y), "by_strategy": {s: nominal_np(x, y, classes, s) for s in ("replace", "drop")},
            "adult": adult, "matrices": matrices, "matrix_bounds": bounds, "probs": probs, "counts": counts,
            "fleiss": fleiss_np(counts)}


def run_path_m3(device, tier_name: str, refs: dict, sizes: dict = M_SIZES):
    """M3, nominal association on one tier: the four association classes at ``m3_classes`` over the
    click-log pair in ``forward`` calls of ``m3_batch`` with each NaN strategy (their confusion
    matrices equal numpy's counts exactly; on the graph tier one capture per class and strategy and
    a replay per later step, no fallback), the four ``_matrix`` functionals over UCI Adult's eight
    columns, and ``FleissKappa`` in ``probs`` (``m3_item_batch`` rows an update) and ``counts`` mode.
    Returns (values, {name: line}, errors)."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.functional import nominal as fn
    from torchmetrics_tpu_torch.ops.dispatch import STATS

    classes, batch = sizes["m3_classes"], sizes["m3_batch"]
    x, y = (torch.from_numpy(a).to(device) for a in refs["pairs"])
    batches = [(x[i:i + batch], y[i:i + batch]) for i in range(0, x.shape[0], batch)]
    values, lines, errors = {}, {}, {}
    for strategy in ("replace", "drop"):
        want = refs["by_strategy"][strategy]
        walls = {}
        for name, key in M3_CLASSES.items():
            m = getattr(tm, name)(num_classes=classes, nan_strategy=strategy, device=device)
            log = StepLog(f"path M3 {name} {strategy}", tier_name)
            _, seconds = loop(log, m, batches)
            if tier_name == "graph":
                log.check(eager_first=0)
            if not np.array_equal(m.metric_state["confmat"].cpu().numpy(), want["table"]):
                raise AssertionError(f"path M3 {name} {strategy}: the confusion matrix differs from numpy's counts")
            sync()
            t0 = time.perf_counter()
            value = m.compute()
            sync()
            walls[name] = (log.line(), (time.perf_counter() - t0) * 1e3)
            errors[f"{name} {strategy}"] = check_rel(f"path M3 {name} {strategy}", value, want[key], M_TOL,
                                                     want[key + "_bound"])
            values[f"{name} {strategy}"] = _bits(value)
        worst = max(errors[f"{name} {strategy}"] / abs(want[key]) for name, key in M3_CLASSES.items())
        lines[f"pairs {strategy}"] = ("; ".join(f"{k}: forward {v[0]}, compute {v[1]:.3f} ms" for k, v in walls.items())
                                      + f"; max relative error against float64 {worst:.3g}")
    adult = torch.from_numpy(refs["adult"]).to(device)
    walls = {}
    for key in M3_CLASSES.values():
        sync()
        t0 = time.perf_counter()
        got = getattr(fn, key + "_matrix")(adult)
        sync()
        walls[key] = (time.perf_counter() - t0) * 1e3
        want = refs["matrices"][key]
        for i, j in zip(*np.nonzero(~np.eye(want.shape[0], dtype=bool))):
            errors[f"adult {key} {i},{j}"] = check_rel(f"path M3 adult {key}_matrix[{i}, {j}]", got[i, j], want[i, j], M_TOL,
                                                       refs["matrix_bounds"][key][i, j])
        values[f"adult {key}"] = _bits(got)
    lines["adult"] = ("_matrix wall ms " + ", ".join(f"{k} {v:.2f}" for k, v in walls.items())
                      + f"; max error against float64 {max(v for k, v in errors.items() if k.startswith('adult')):.3g}")
    fleiss_walls = {}
    for mode in ("probs", "counts"):
        ratings = torch.from_numpy(refs[mode]).to(device)
        step = sizes["m3_item_batch"]
        m = tm.FleissKappa(mode=mode, device=device)
        for i in range(0, ratings.shape[0], step):
            m.update(ratings[i:i + step])
        sync()
        t0 = time.perf_counter()
        value = m.compute()
        sync()
        fleiss_walls[mode] = (time.perf_counter() - t0) * 1e3
        errors[f"FleissKappa {mode}"] = check_rel(f"path M3 FleissKappa {mode}", value, *refs["fleiss"][:1], M_TOL,
                                                  refs["fleiss"][1])
        values[f"FleissKappa {mode}"] = _bits(value)
        if _bits(fn.fleiss_kappa(ratings, mode)) != values[f"FleissKappa {mode}"]:
            raise AssertionError(f"path M3 FleissKappa {mode}: the functional entry differs from the class")
    lines["fleiss"] = (f"{refs['probs'].shape[0]:,} items, 10 categories, 5 raters, updates of {sizes['m3_item_batch']:,};"
                       " compute wall ms " + ", ".join(f"{k} {v:.3f}" for k, v in fleiss_walls.items())
                       + f"; kappa {refs['fleiss'][0]:.7g}, errors {errors['FleissKappa probs']:.3g} and"
                       f" {errors['FleissKappa counts']:.3g} (bound {refs['fleiss'][1]:.3g})")
    return values, lines, errors


# ---------------------------------------------------------------------------------------------
# Path N: the sketches, retrieval's sketch mode and the keyed engine, on K1 and K2
N_TOL = 1e-5
#: path N's full sizes; the tests pass smaller ones
N_SIZES = {"n1_bench_batches": 16, "n1_bench_batch": 65_536, "n1_latency_batches": 100, "n1_latency_batch": 65_536,
           "n1_cm_batches": 100, "n1_cm_batch": 100_000, "n1_cm_vocab": 1_000_000, "n2_docs": 1 << 20, "n2_queries": 10_000,
           "n2_aligned_queries": 100, "n2_fixed_batches": 16, "n2_ragged_docs": 50_000, "n2_ragged_queries": 1_000,
           "n3_keys": (1_000, 10_000, 100_000), "n3_batches": 50, "n3_batch": 8_192, "n3_stats_keys": 10_000,
           "n3_auroc_keys": 100, "n3_auroc_bins": 2048, "n3_hist_keys": 1_000, "n3_quantile_keys": 64,
           "n3_quantile_capacity": 8, "n3_quantile_batches": 10, "n3_quantile_batch": 256}
#: the count-min sketch's shape on path N1 (``sketch/countmin.py`` defaults)
N_CM_DEPTH, N_CM_WIDTH = 4, 1024
#: the JAX package's row constants of the count-min hash (``sketch/countmin.py:32``)
CM_MULTIPLIERS = (2654435761, 2246822519, 3266489917, 668265263)


def on_card(device, counter):
    """``counter`` where ``device`` is a card, else None: CPU calls launch nothing (the CPU dry runs)."""
    return counter if torch.device(device).type == "cuda" else None


def countmin_buckets_np(ids: np.ndarray, depth: int = N_CM_DEPTH, width: int = N_CM_WIDTH) -> np.ndarray:
    """``(depth, N)`` count-min buckets in numpy's native uint32 arithmetic: ``h = id·m_d +
    0x9E3779B9·(d+1) mod 2^32``, bucket ``(h >> 16) % width``."""
    ids_u = ids.reshape(-1).astype(np.int64).astype(np.uint32)
    with np.errstate(over="ignore"):
        rows = [(ids_u * np.uint32(CM_MULTIPLIERS[d]) + np.uint32(0x9E3779B9 * (d + 1) & 0xFFFFFFFF)) >> np.uint32(16)
                for d in range(depth)]
    return np.stack([(r % np.uint32(width)).astype(np.int64) for r in rows])


def countmin_np(ids: np.ndarray, depth: int = N_CM_DEPTH, width: int = N_CM_WIDTH) -> np.ndarray:
    """The count-min state of ``ids`` as float64 counts ``(depth, width)``."""
    return np.stack([np.bincount(row, minlength=width) for row in countmin_buckets_np(ids, depth, width)]).astype(np.float64)


def straddled_np(id_batches, depth: int = N_CM_DEPTH, width: int = N_CM_WIDTH) -> int:
    """Retrieval's sketch-mode straddle count in numpy: each batch's distinct ids whose every row's
    bucket is already nonzero in the sketch of the batches before, then those ids counted in."""
    state, total = np.zeros((depth, width)), 0
    for ids in id_batches:
        buckets = countmin_buckets_np(np.unique(ids), depth, width)
        total += int(np.sum(state[np.arange(depth)[:, None], buckets].min(0) > 0))
        for d in range(depth):
            state[d] += np.bincount(buckets[d], minlength=width)
    return total


def stream_hist_np(values: np.ndarray, bins: int, lo: float, hi: float) -> np.ndarray:
    """``StreamingHistogram``'s bucket counts in numpy, in float32 as the metric buckets: the value
    mapped to ``[0, 1]`` and clipped, then ``floor(u·(bins - 1))``, as ``sketch/hist.py::score_bucket``."""
    unit = np.clip((values.astype(np.float32) - np.float32(lo)) / np.float32(hi - lo), 0, 1).astype(np.float32)
    idx = np.clip(np.floor(unit * np.float32(bins - 1)), 0, bins - 1).astype(np.int64)
    return np.bincount(idx.reshape(-1), minlength=bins).astype(np.float64)


def rank_error_np(sorted_all: np.ndarray, estimates, qs) -> float:
    """The largest distance, as a fraction of the stream, between each estimate's rank range and its
    probability (0 where the range holds it)."""
    n = sorted_all.size
    errs = []
    for est, q in zip(np.atleast_1d(np.asarray(estimates, np.float64)), qs):
        lo, hi = np.searchsorted(sorted_all, est, "left") / n, np.searchsorted(sorted_all, est, "right") / n
        errs.append(0.0 if lo <= q <= hi else min(abs(lo - q), abs(hi - q)))
    return max(errs)


def path_n1_data(sizes: dict = N_SIZES) -> dict:
    """N1's streams: bench.py's quantile protocol (``bench.py:720-811``, seed 17: the curve sketch's
    two uniform draws first, then the normals), request latencies lognormal(3, 1) (seed 51) and a click
    log's Zipf(1.2) query ids folded into a vocabulary (seed 53)."""
    rng = np.random.RandomState(17)
    shape = (sizes["n1_bench_batches"], sizes["n1_bench_batch"])
    rng.uniform(0.0, 1.0, shape)
    rng.uniform(0, 1, shape)
    bench = rng.normal(0.0, 1.0, shape).astype(np.float32)
    latencies = np.random.RandomState(51).lognormal(3.0, 1.0, (sizes["n1_latency_batches"], sizes["n1_latency_batch"]))
    ids = (np.random.RandomState(53).zipf(1.2, (sizes["n1_cm_batches"], sizes["n1_cm_batch"])) - 1) % sizes["n1_cm_vocab"]
    return {"bench": bench, "latencies": latencies.astype(np.float32), "ids": ids.astype(np.int64)}


def path_n1_refs(data: dict) -> dict:
    """N1's numpy side: the sorted streams, the histogram's counts, the count-min state and the true id counts."""
    ids = data["ids"]
    uniq, counts = np.unique(ids, return_counts=True)
    return {"bench_sorted": np.sort(data["bench"].reshape(-1)), "latencies_sorted": np.sort(data["latencies"].reshape(-1)),
            "hist": stream_hist_np(data["latencies"], 64, 0.0, 2000.0), "cms": countmin_np(ids), "uniq": uniq,
            "counts": counts.astype(np.float64)}


def run_path_n1(device, tier_name: str, data: dict, refs: dict, cpu_state: torch.Tensor):
    """N1, the sketch kinds on one tier: ``StreamingQuantile`` over bench.py's quantile protocol and
    over the serving dashboard's latencies (rank error within ``kll.DEFAULT_RANK_ERROR``, the count
    exact, the state ``cpu_state``'s bits, the two halves' merge commutative bit for bit),
    ``StreamingHistogram(bins=64, lo=0, hi=2000)`` over the latencies (numpy's counts exactly; one K2
    ``hist_pair`` launch an update) and the count-min sketch over the click log (numpy's state exactly,
    one K1 launch an update, never under a true count, ``1 - e^-4`` of the ids within ``e·n/width``).
    Returns (values, {name: line})."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.ops import bincount as k1
    from torchmetrics_tpu_torch.ops import hist_pair as k2
    from torchmetrics_tpu_torch.sketch import countmin, kll

    values, lines = {}, {}
    qs = {"bench": (0.1, 0.5, 0.99), "latencies": (0.5, 0.9, 0.99)}
    for name in ("bench", "latencies"):
        stream = torch.from_numpy(data[name]).to(device)
        m = tm.StreamingQuantile(q=qs[name], device=device)
        log = StepLog(f"path N1 StreamingQuantile {name}", tier_name)
        _, seconds = loop(log, m.update, [(b,) for b in stream])
        if tier_name == "graph":
            log.check(eager_first=0)
        est = m.compute().cpu().numpy()
        err = rank_error_np(refs[f"{name}_sorted"], est, qs[name])
        count = float(m.total_count)
        if err > kll.DEFAULT_RANK_ERROR or count != data[name].size:
            raise AssertionError(f"path N1 {name}: rank error {err} (bound {kll.DEFAULT_RANK_ERROR}), count {count} of"
                                 f" {data[name].size}")
        values[name] = _bits(m.metric_state["sketch"])
        lines[f"StreamingQuantile {name}"] = (f"{stream.shape[0]} updates of {stream.shape[1]:,}: {stream.numel() / seconds:.4g}"
                                              f" samples/s, {log.line()}; q {qs[name]} = {est.tolist()}, rank error {err:.3g}")
        if name == "latencies":
            if values[name] != _bits(cpu_state):
                raise AssertionError("path N1 latencies: the card's KLL state differs from the CPU's bits")
            half = stream.shape[0] // 2
            parts = [tm.StreamingQuantile(q=qs[name], device=device) for _ in range(2)]
            for part, chunk in zip(parts, (stream[:half], stream[half:])):
                part.update_batches(chunk)
            a, b = (p.metric_state["sketch"] for p in parts)
            ab, ba = kll.kll_merge(a, b), kll.kll_merge(b, a)
            if not torch.equal(ab, ba) or float(kll.kll_count(ab)) != data[name].size:
                raise AssertionError("path N1 latencies: the halves' merge is not commutative bit for bit, or loses weight")
            lines["merge"] = f"the two halves ({half} updates each, update_batches) merge to the same bits in either order"
    stream = torch.from_numpy(data["latencies"]).to(device)
    hist = tm.StreamingHistogram(bins=64, lo=0.0, hi=2000.0, device=device)
    log = StepLog("path N1 StreamingHistogram", tier_name, on_card(device, k2.HIST_PAIR))
    _, seconds = loop(log, hist.update, [(b,) for b in stream])
    log.check(eager_first=1)
    got = hist.compute().cpu().numpy()
    if not np.array_equal(got, refs["hist"]):
        raise AssertionError(f"path N1 StreamingHistogram: counts differ from numpy's by {np.abs(got - refs['hist']).max()}")
    values["hist"] = _bits(hist.compute())
    lines["StreamingHistogram"] = f"64 bins over [0, 2000): {stream.numel() / seconds:.4g} samples/s, {log.line()}"
    ids = torch.from_numpy(data["ids"]).to(device)
    state = countmin.cm_init(N_CM_DEPTH, N_CM_WIDTH).to(device)
    before = k1.BINCOUNT.launches
    sync()
    t0 = time.perf_counter()
    for batch in ids:
        state = countmin.cm_update(state, batch)
    sync()
    seconds = time.perf_counter() - t0
    if on_card(device, k1.BINCOUNT) and k1.BINCOUNT.launches - before != ids.shape[0]:
        raise AssertionError(f"path N1 count-min: {k1.BINCOUNT.launches - before} K1 launches for {ids.shape[0]} updates")
    if not np.array_equal(state.cpu().numpy(), refs["cms"]):
        raise AssertionError("path N1 count-min: the state differs from numpy's hashed counts")
    est = countmin.cm_query(state, torch.from_numpy(refs["uniq"]).to(device)).cpu().numpy()
    over = est - refs["counts"]
    within = float(np.mean(over <= np.e * ids.numel() / N_CM_WIDTH))
    if over.min() < 0 or within < 1 - np.exp(-N_CM_DEPTH):
        raise AssertionError(f"path N1 count-min: an estimate under its count ({over.min()}), or {within} of the ids within"
                             " e·n/width")
    values["cms"] = _bits(state)
    lines["count-min"] = (f"depth {N_CM_DEPTH}, width {N_CM_WIDTH}, {ids.shape[0]} updates of {ids.shape[1]:,} Zipf(1.2) ids:"
                          f" {ids.numel() / seconds:.4g} ids/s, {refs['uniq'].size:,} distinct ids, {within:.4f} within e·n/width,"
                          f" largest overestimate {over.max():.0f}")
    return values, lines


def path_n2_data(sizes: dict = N_SIZES) -> dict:
    """Path H's documents (seed 9, ``bench.py:2193-2197``) and the ragged set's (seed 19)."""
    n, n_queries = sizes["n2_docs"], sizes["n2_queries"]
    rng = np.random.RandomState(9)
    preds = rng.rand(n).astype(np.float32)
    target = rng.randint(0, 2, size=n).astype(np.int32)
    indexes = np.sort(rng.randint(0, n_queries, size=n)).astype(np.int32)
    n_r, q_r = sizes["n2_ragged_docs"], sizes["n2_ragged_queries"]
    rng = np.random.RandomState(19)
    r_indexes = np.sort(rng.randint(0, q_r, n_r)).astype(np.int64)
    r_preds = (rng.randint(0, 32, n_r) / 32.0).astype(np.float32)
    r_target = rng.randint(0, 2, n_r)
    r_target[r_indexes % 17 == 0] = 0  # no positives
    r_target[r_indexes % 29 == 3] = 1  # no negatives
    r_target[(rng.rand(n_r) < 0.1) | (r_indexes % 23 == 5)] = -1  # ignored documents, and queries with all of them ignored
    return {"h": (preds, target, indexes), "ragged": (r_preds, r_target, r_indexes)}


def _cuts(indexes: np.ndarray, every: int) -> np.ndarray:
    """Document offsets of the batches that hold ``every`` consecutive query ids each, cut at query starts."""
    return np.searchsorted(indexes, np.arange(0, int(indexes.max()) + every + 1, every), "left")


def fragments_np(batches, ignore_index=None):
    """``queries_np`` of each batch apart: a query cut by a batch edge is one fragment per batch."""
    return [q for p, t, i in batches for q in queries_np(i, p, t, ignore_index)]


N2_CONFIGS = tuple((name, {}) for name in RAGGED_SCALARS) + (("RetrievalMAP", {"aggregation": "min"}),
                                                             ("RetrievalMAP", {"aggregation": "max"}))


def run_path_n2(device, tier_name: str, data: dict, sizes: dict = N_SIZES):
    """N2, retrieval's sketch mode on one tier: path H's documents in query-aligned batches of
    ``n2_aligned_queries`` queries through the eight scalar classes and MAP's min and max (each value
    within 1e-5 of exact mode's on the same documents, the straddle count numpy's count-min's); in ``n2_fixed_batches``
    equal batches through MAP (the straddle count at least the queries a cut splits, the warning given,
    the value a numpy evaluation per fragment's within 1e-5); and the ragged set's two halves in each
    empty action through four classes (against numpy per fragment; ``"error"`` raises at ``update``).
    Returns (values, {name: line})."""
    import torchmetrics_tpu_torch.retrieval as retrieval
    from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserWarning

    preds, target, indexes = data["h"]
    p, t, i = (torch.from_numpy(x).to(device) for x in (preds, target, indexes))
    cuts = _cuts(indexes, sizes["n2_aligned_queries"])
    aligned = [(p[lo:hi], t[lo:hi], i[lo:hi]) for lo, hi in zip(cuts[:-1], cuts[1:]) if hi > lo]
    aligned_straddled = straddled_np([indexes[lo:hi] for lo, hi in zip(cuts[:-1], cuts[1:]) if hi > lo])
    values, lines, walls = {}, {}, {}
    for name, kwargs in N2_CONFIGS:
        label = f"{name} {kwargs}" if kwargs else name
        m = getattr(retrieval, name)(approx="sketch", device=device, **kwargs)
        sync()
        t0 = time.perf_counter()
        for batch in aligned:
            m.update(*batch[:2], indexes=batch[2])
        sync()
        walls[label] = (time.perf_counter() - t0) / len(aligned)
        exact = getattr(retrieval, name)(device=device, **kwargs)
        exact.update(p, t, indexes=i)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the straddle warning: the sketch's false positives, checked below
            got = m.compute()
        check_value(f"path N2 {label} aligned ({tier_name} tier)", got, float(exact.compute()), N_TOL)
        if m.straddled_queries != aligned_straddled:
            raise AssertionError(f"path N2 {label}: {m.straddled_queries} queries counted straddled, numpy's count-min"
                                 f" gives {aligned_straddled}")
        values[label] = _bits(got)
    lines["aligned"] = (f"{len(aligned)} query-aligned batches (no query straddles; the sketch counts {aligned_straddled}"
                        f" of {np.unique(indexes).size:,} as numpy's count-min does): update wall ms " +
                        ", ".join(f"{k} {v * 1e3:.3f}" for k, v in walls.items()))
    step = -(-preds.shape[0] // sizes["n2_fixed_batches"])
    fixed = [tuple(x[lo:lo + step] for x in (preds, target, indexes)) for lo in range(0, preds.shape[0], step)]
    cut = sum(int(indexes[lo - 1] == indexes[lo]) for lo in range(step, preds.shape[0], step))
    m = retrieval.RetrievalMAP(approx="sketch", device=device)
    for a, b, c in fixed:
        m.update(torch.from_numpy(a).to(device), torch.from_numpy(b).to(device), indexes=torch.from_numpy(c).to(device))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = m.compute()
    fixed_straddled = straddled_np([c for _, _, c in fixed])
    if (m.straddled_queries < cut or m.straddled_queries != fixed_straddled
            or not any(issubclass(w.category, TorchMetricsUserWarning) for w in caught)):
        raise AssertionError(f"path N2 fixed batches: {m.straddled_queries} straddled, numpy cuts {cut} and its count-min"
                             f" counts {fixed_straddled}; warnings {[str(w.message) for w in caught]}")
    check_value(f"path N2 fixed batches ({tier_name} tier)", got, retrieval_np("RetrievalMAP", fragments_np(fixed)), N_TOL)
    values["fixed"] = (_bits(got), m.straddled_queries)
    lines["fixed"] = (f"{len(fixed)} batches of {step:,}: {m.straddled_queries} queries counted straddled (numpy: {cut} cut"
                      f" by an edge, its count-min {fixed_straddled}), the warning given, MAP per fragment {float(got):.7f}")
    r = data["ragged"]
    half = r[0].shape[0] // 2
    halves = [tuple(x[:half] for x in r), tuple(x[half:] for x in r)]
    ragged_frags = {name: fragments_np(halves, -1) for name in ("binary",)}
    count = 0
    for name in ("RetrievalMAP", "RetrievalMRR", "RetrievalFallOut", "RetrievalNormalizedDCG"):
        for action in ("neg", "pos", "skip", "error"):
            m = getattr(retrieval, name)(approx="sketch", empty_target_action=action, ignore_index=-1, device=device)
            label = f"path N2 ragged {name} {action} ({tier_name} tier)"
            try:
                for a, b, c in halves:
                    m.update(*(torch.from_numpy(x).to(device) for x in (a, b)), indexes=torch.from_numpy(c).to(device))
            except ValueError:
                if action == "error":
                    values[f"ragged {name} {action}"] = "raised"
                    count += 1
                    continue
                raise
            if action == "error":
                raise AssertionError(f"{label}: the 'error' action did not raise at update")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # the halves cut queries: the straddle warning is expected
                got = m.compute()
            check_value(label, got, retrieval_np(name, ragged_frags["binary"], action=action), N_TOL)
            values[f"ragged {name} {action}"] = _bits(got)
            count += 1
    lines["ragged"] = (f"{r[0].shape[0]:,} documents over {sizes['n2_ragged_queries']:,} ids in two halves, tied scores,"
                       f" ignore_index=-1: {count} configs equal numpy per fragment, 'error' raised at update")
    return values, lines


def keyed_sums_np(ids: np.ndarray, vals: np.ndarray, n_keys: int) -> np.ndarray:
    return np.bincount(ids.reshape(-1), weights=vals.reshape(-1).astype(np.float64), minlength=n_keys)


def path_n3_data(sizes: dict = N_SIZES) -> dict:
    """N3's streams: bench.py's keyed protocol (``bench.py:258-300``, seed 11: the ids and integer values
    of each N in turn), normal values for the mean, max and min (seed 55), and a CTR model's scores per
    advertiser (seed 57): uniform scores and clicks drawn at ``0.8·score + 0.1``."""
    rng = np.random.RandomState(11)
    shape = (sizes["n3_batches"], sizes["n3_batch"])
    bench = {n: (rng.randint(0, n, size=shape).astype(np.int32), rng.randint(0, 64, size=shape).astype(np.float32))
             for n in sizes["n3_keys"]}
    rng = np.random.RandomState(55)
    stats = (rng.randint(0, sizes["n3_stats_keys"], size=shape).astype(np.int32), rng.normal(0, 1, shape).astype(np.float32))
    rng = np.random.RandomState(57)
    scores = rng.uniform(0, 1, shape).astype(np.float32)
    clicks = (rng.uniform(0, 1, shape) < 0.8 * scores + 0.1).astype(np.int32)
    auroc = (rng.randint(0, sizes["n3_auroc_keys"], size=shape).astype(np.int32), scores, clicks,
             rng.randint(0, sizes["n3_hist_keys"], size=shape).astype(np.int32))
    qshape = (sizes["n3_quantile_batches"], sizes["n3_quantile_batch"])
    quantile = (rng.randint(0, sizes["n3_quantile_keys"], size=qshape).astype(np.int32),
                rng.lognormal(3.0, 1.0, qshape).astype(np.float32))
    return {"bench": bench, "stats": stats, "auroc": auroc, "quantile": quantile}


def path_n3_refs(device, data: dict, sizes: dict = N_SIZES) -> dict:
    """N3's per-key references, built before the kernel counts are set to 0: ``"quantile"``, each key's
    KLL state from a plain ``StreamingQuantile`` per key fed that key's values one at a time (one graph
    replay an update on the card), stacked ``(keys, levels, capacity + 2)``; ``"auroc"``, each
    advertiser's ``pos_hist``/``neg_hist`` and value from a plain sketched ``BinaryAUROC`` fed that
    key's rows of all the batches (one K2 ``sketch_update`` launch each)."""
    import torchmetrics_tpu_torch as tm

    ids, vals = data["quantile"]
    insts = [tm.StreamingQuantile(capacity=sizes["n3_quantile_capacity"], device=device)
             for _ in range(sizes["n3_quantile_keys"])]
    v = torch.from_numpy(vals).to(device).reshape(-1, 1)
    for row, key in enumerate(ids.reshape(-1)):
        insts[key].update(v[row])
    ids_np, scores_np, clicks_np, _ = data["auroc"]
    pos, neg, auroc = [], [], []
    for key in range(sizes["n3_auroc_keys"]):
        rows = ids_np == key
        plain = tm.classification.BinaryAUROC(approx="sketch", sketch_bins=sizes["n3_auroc_bins"], device=device)
        plain.update(torch.from_numpy(scores_np[rows]).to(device), torch.from_numpy(clicks_np[rows]).to(device))
        pos.append(plain.metric_state["pos_hist"])
        neg.append(plain.metric_state["neg_hist"])
        auroc.append(float(plain.compute()))
    return {"quantile": torch.stack([m.metric_state["sketch"] for m in insts]),
            "auroc": (torch.stack(pos), torch.stack(neg), np.asarray(auroc))}


def run_path_n3(device, tier_name: str, data: dict, refs: dict, sizes: dict = N_SIZES):
    """N3, the keyed engine on one tier: bench.py's keyed protocol for each N (numpy's sums exactly,
    ``compute(keys=...)`` of 100 keys the same rows, updates/s best of three windows), the mean, max
    and min at ``n3_stats_keys`` (float64 numpy's within 1e-6 relative; max on the vmap strategy equal
    to segments; the collection of sum and max), the per-advertiser sketched AUROC (each key's histogram
    pair that of a plain sketched ``BinaryAUROC`` fed its rows, values within 1e-6: ``refs["auroc"]``;
    one K2 ``sketch_update`` launch an update and no ``hist_pair``), a keyed ``StreamingHistogram``
    (numpy's counts; one ``hist_pair`` launch an update) and a keyed ``StreamingQuantile`` on the vmap
    strategy (each key ``refs["quantile"]``'s bits, and some key's sketch past level 1).
    Returns (values, {name: line})."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.keyed import KeyedMetric, KeyedMetricCollection
    from torchmetrics_tpu_torch.ops import hist_pair as k2

    dev = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    values, lines = {}, {}
    for n_keys, (ids_np, vals_np) in data["bench"].items():
        ids, vals = dev(ids_np), dev(vals_np)
        km = KeyedMetric(tm.SumMetric(nan_strategy="ignore", device=device), n_keys)
        km.update(ids[0], vals[0])  # the capture, out of the window
        seconds = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            km.reset()
            for b in range(ids.shape[0]):
                km.update(ids[b], vals[b])
            table = km.compute()
            sync()
            seconds.append(time.perf_counter() - t0)
        want = keyed_sums_np(ids_np, vals_np, n_keys)
        if not np.array_equal(table.cpu().numpy(), want) or km.active_keys != np.unique(ids_np).size:
            raise AssertionError(f"path N3 keyed Sum N={n_keys}: the table differs from numpy's sums")
        some = np.random.RandomState(n_keys).choice(n_keys, min(100, n_keys), replace=False)
        if not torch.equal(km.compute(keys=some), table[dev(some)]):
            raise AssertionError(f"path N3 keyed Sum N={n_keys}: compute(keys=...) differs from the table's rows")
        values[f"sum {n_keys}"] = _bits(table)
        lines[f"Sum N={n_keys}"] = f"{ids.shape[0] / min(seconds):.6g} updates/s of {ids.shape[1]:,} (best of 3 windows)"
    ids_np, vals_np = data["stats"]
    ids, vals = dev(ids_np), dev(vals_np)
    n_keys = sizes["n3_stats_keys"]
    counts = np.bincount(ids_np.reshape(-1), minlength=n_keys)
    flat_ids, flat_vals = ids_np.reshape(-1), vals_np.reshape(-1).astype(np.float64)
    maxes, mins = np.full(n_keys, -np.inf), np.full(n_keys, np.inf)
    np.maximum.at(maxes, flat_ids, flat_vals)
    np.minimum.at(mins, flat_ids, flat_vals)
    want = {"MeanMetric": np.where(counts > 0, keyed_sums_np(ids_np, vals_np, n_keys) / np.maximum(counts, 1), 0.0),
            "MaxMetric": maxes, "MinMetric": mins, "SumMetric": keyed_sums_np(ids_np, vals_np, n_keys)}
    # a key's float32 sum of ~n values: within (n + K_SERIAL)·u of the sum of their magnitudes
    abs_sums = np.bincount(flat_ids, weights=np.abs(flat_vals), minlength=n_keys)
    mean_bound = (counts + K_SERIAL) * U32 * abs_sums / np.maximum(counts, 1)
    worst = {}
    for name in ("MeanMetric", "MaxMetric", "MinMetric"):
        km = KeyedMetric(getattr(tm, name)(device=device), n_keys)
        km.update_batches(ids, vals)
        got = km.compute().double().cpu().numpy()
        err = np.where(got == want[name], 0.0, np.abs(got - want[name]))  # keys never updated hold -inf or +inf
        allowed = np.maximum(1e-6 * np.abs(want[name]), mean_bound if name == "MeanMetric" else 0.0)
        if not (err <= allowed).all():
            raise AssertionError(f"path N3 keyed {name}: {np.max(err - allowed):.3g} beyond 1e-6 relative or the float32 bound")
        worst[name] = float(np.max(err))
        values[name] = _bits(km.compute())
    by_strategy = {}
    for strategy in ("segments", "vmap"):
        km = KeyedMetric(tm.MaxMetric(device=device), n_keys, strategy=strategy)
        sync()
        t0 = time.perf_counter()
        for b in range(ids.shape[0]):
            km.update(ids[b], vals[b])
        by_strategy[strategy] = (km.compute(), time.perf_counter() - t0)
    if not torch.equal(by_strategy["vmap"][0], by_strategy["segments"][0]):
        raise AssertionError("path N3 keyed Max: the vmap strategy differs from segments")
    kc = KeyedMetricCollection([tm.SumMetric(device=device), tm.MaxMetric(device=device)], num_keys=n_keys)
    for b in range(ids.shape[0]):
        kc.update(ids[b], vals[b])
    out = kc.compute()
    if not (np.allclose(out["SumMetric"].double().cpu().numpy(), want["SumMetric"], rtol=1e-5, atol=1e-4)
            and _bits(out["MaxMetric"]) == values["MaxMetric"]):
        raise AssertionError("path N3 KeyedMetricCollection: its members differ from the keyed metrics")
    values["collection"] = _bits(out)
    lines["Mean, Max, Min"] = (f"N={n_keys:,}, {ids.shape[0]} batches of {ids.shape[1]:,} in one update_batches each:"
                               f" largest error against float64 {worst} (Max and Min exact, the mean within 1e-6 relative or"
                               f" its float32 bound, at most {float(mean_bound.max()):.3g}); Max by update over the same batches: segments"
                               f" {by_strategy['segments'][1] * 1e3:.1f} ms, vmap {by_strategy['vmap'][1] * 1e3:.1f} ms, equal")
    ids_np, scores_np, clicks_np, hist_ids_np = data["auroc"]
    ids, scores, clicks, hist_ids = dev(ids_np), dev(scores_np), dev(clicks_np), dev(hist_ids_np)
    bins = sizes["n3_auroc_bins"]
    kw = {"approx": "sketch", "sketch_bins": bins}
    km = KeyedMetric(tm.classification.BinaryAUROC(**kw, device=device), sizes["n3_auroc_keys"])
    pair_before = k2.HIST_PAIR.launches
    log = StepLog("path N3 keyed AUROC", tier_name, on_card(device, k2.SKETCH_UPDATE))
    _, seconds = loop(log, km.update, list(zip(ids, scores, clicks)))
    log.check(eager_first=1)
    if k2.HIST_PAIR.launches != pair_before:
        raise AssertionError("path N3 keyed AUROC: hist_pair launched where only sketch_update may")
    got = km.compute()
    ref_pos, ref_neg, ref_values = refs["auroc"]
    for state, ref in (("pos_hist", ref_pos), ("neg_hist", ref_neg)):
        if not torch.equal(km.metric_state[state], ref):
            differ = torch.nonzero((km.metric_state[state] != ref).any(dim=1)).reshape(-1).tolist()
            raise AssertionError(f"path N3 keyed AUROC keys {differ[:5]}: their {state} differs from the plain metrics'")
    err = float(np.max(np.abs(got.double().cpu().numpy() - ref_values)))
    if not err <= 1e-6:
        raise AssertionError(f"path N3 keyed AUROC: values {err:.3g} from the plain metrics'")
    values["auroc"] = _bits(got)
    lines["AUROC"] = (f"{sizes['n3_auroc_keys']} advertisers, {bins} bins, {ids.shape[0]} updates of {ids.shape[1]:,}:"
                      f" {ids.shape[0] / seconds:.5g} updates/s, {log.line()}; histogram pairs equal the plain metrics',"
                      f" values within {err:.3g}")
    n_hist = sizes["n3_hist_keys"]
    kh = KeyedMetric(tm.StreamingHistogram(bins=64, device=device), n_hist)
    log = StepLog("path N3 keyed StreamingHistogram", tier_name, on_card(device, k2.HIST_PAIR))
    _, seconds = loop(log, kh.update, list(zip(hist_ids, scores)))
    log.check(eager_first=1)
    unit = np.clip(scores_np.reshape(-1), 0, 1)
    bucket = np.clip(np.floor(unit * np.float32(63)), 0, 63).astype(np.int64)
    want = np.bincount(hist_ids_np.reshape(-1).astype(np.int64) * 64 + bucket, minlength=n_hist * 64).reshape(n_hist, 64)
    if not np.array_equal(kh.compute().cpu().numpy(), want):
        raise AssertionError("path N3 keyed StreamingHistogram: the table differs from numpy's counts")
    values["hist"] = _bits(kh.compute())
    lines["StreamingHistogram"] = f"{n_hist:,} keys, 64 bins: {hist_ids.shape[0] / seconds:.5g} updates/s, {log.line()}"
    q_ids, q_vals = (dev(x) for x in data["quantile"])
    capacity = sizes["n3_quantile_capacity"]
    kq = KeyedMetric(tm.StreamingQuantile(capacity=capacity, device=device), sizes["n3_quantile_keys"])
    if kq.strategy != "vmap":
        raise AssertionError(f"path N3 keyed StreamingQuantile: strategy {kq.strategy}")
    log = StepLog("path N3 keyed StreamingQuantile", tier_name)
    _, seconds = loop(log, kq.update, list(zip(q_ids, q_vals)))
    if tier_name == "graph":
        log.check(eager_first=0)
    table = kq.metric_state["sketch"]
    if not torch.equal(table, refs["quantile"]):
        raise AssertionError("path N3 keyed StreamingQuantile: a key's state differs from its instance fed one value at a time")
    top = int(torch.nonzero(table[:, :, capacity].amax(dim=0) > 0).max())  # column `capacity`: a level's count
    if top < 2:
        raise AssertionError(f"path N3 keyed StreamingQuantile: no key's sketch compacted past level 1 (top level {top})")
    values["quantile"] = _bits(kq.compute())
    lines["StreamingQuantile"] = (f"{sizes['n3_quantile_keys']} keys, capacity {capacity}, on the vmap strategy, {q_ids.shape[0]}"
                                  f" updates of {q_ids.shape[1]}: {q_ids.numel() / seconds:.5g} elements/s, {log.line()}; every key"
                                  f" bit-equal to its instance fed one value at a time, levels 0-{top} in use")
    return values, lines


def run_path_n(device, card: str):
    """Path N on both tiers: the numpy side, the port's CPU KLL state of N1's latencies and N3's per-key
    references (``path_n3_refs``) first, then every kernel's count set to 0, N1-N3 on the graph tier and
    on the eager tier, bit-equal, each part launching its kernels and never K3. Returns the graph
    tier's K1 and K2 launches, and N1's and N3's data for the timings."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.ops.bincount import LaunchCounter

    started_n = time.perf_counter()
    n1_data, n2_data, n3_data = path_n1_data(), path_n2_data(), path_n3_data()
    n1_refs = path_n1_refs(n1_data)
    cpu_quantile = tm.StreamingQuantile(q=(0.5, 0.9, 0.99), device="cpu")
    for batch in torch.from_numpy(n1_data["latencies"]):
        cpu_quantile.update(batch)
    cpu_state = cpu_quantile.metric_state["sketch"]
    n3_refs = path_n3_refs(device, n3_data)
    print(f"path N: data, numpy side, the CPU's KLL state and N3's per-key references in"
          f" {time.perf_counter() - started_n:.1f} s")
    for counter in LaunchCounter.ALL:
        counter.launches = 0
    res_n, launches_n = {}, {}
    for tier_name in ("graph", "eager"):
        with tier(tier_name):
            r = res_n[tier_name] = {}
            for part in ("N1", "N2", "N3"):
                before = {k: c.launches for k, c in kernel_counters().items()}
                t_part = time.perf_counter()
                if part == "N1":
                    r[part], lines_n = run_path_n1(device, tier_name, n1_data, n1_refs, cpu_state)
                elif part == "N2":
                    r[part], lines_n = run_path_n2(device, tier_name, n2_data)
                else:
                    r[part], lines_n = run_path_n3(device, tier_name, n3_data, n3_refs)
                launches_n[(tier_name, part)] = {k: c.launches - before[k] for k, c in kernel_counters().items()}
                for label, line in lines_n.items():
                    print(f"path {part} [{card}] {label}, {tier_name} tier: {line}")
                print(f"path {part} [{card}] {tier_name} tier: {time.perf_counter() - t_part:.1f} s, kernel launches"
                      f" {launches_n[(tier_name, part)]}")
    same_on_both_tiers("path N", res_n["graph"], res_n["eager"])
    for (tier_name, part), counts in launches_n.items():
        must = {"N1": ("K1", "K2 hist_pair"), "N2": ("K1",), "N3": ("K2 sketch_update", "K2 hist_pair")}[part]
        if min(counts[k] for k in must) == 0 or counts["K3 binned_confmat"] or counts["K3 direct"]:
            raise AssertionError(f"path {part} ({tier_name} tier): a kernel of the part launched no time, or K3 launched: {counts}")
    launches_n_k1 = sum(c["K1"] for (t, _), c in launches_n.items() if t == "graph")
    launches_n_k2 = sum(c["K2 hist_pair"] + c["K2 sketch_update"] for (t, _), c in launches_n.items() if t == "graph")
    print(f"path N [{card}]: both tiers bit-equal; {time.perf_counter() - started_n:.1f} s")
    return launches_n_k1, launches_n_k2, n1_data, n3_data


O_TOL = 1e-5
#: path O's full sizes; the tests pass smaller ones
O_SIZES = {"o1_batch": 2048, "o1_batches": 256, "o1_window": 8, "o1_every": 8,
           "o2_batches": 240, "o2_batch": 65_536, "o2_bins": 2048, "o2_thresholds": 200, "o2_window": 12, "o2_every": 10,
           "o3_batches": 240, "o3_batch": 8192, "o3_classes": 1000, "o3_window": 12, "o3_every": 10,
           "o4_stationary": 60, "o4_shifted": 40, "o4_batch": 65_536, "o4_reference": 10, "o4_window": 12, "o4_every": 5,
           "o4_stock_quiet": True, "o5_steps": 20, "o5_batch": 10_000}
#: the decay of path O's ``Ema`` metrics
O_DECAY = 0.99
#: O4's alarm thresholds: a shift of the log-latency by half a standard deviation, over a window at most
#: three quarters shifted, peaks near KS 0.14 and PSI 0.12, below the stock thresholds (KS 0.15, PSI
#: 0.25); the stationary part stays under KS 0.02 and PSI 0.007. The stock specs watch the same window
#: and, at the full size (``o4_stock_quiet``), must stay quiet; at a few thousand latencies a batch the
#: sampling noise alone moves the KS by a few hundredths, enough to cross 0.15
O4_KS_THRESHOLD, O4_PSI_THRESHOLD = 0.1, 0.05


def window_slice(n_updates: int, window: int, every: int) -> slice:
    """The updates a ring of ``window`` sub-windows of ``every`` updates covers after ``n_updates``
    (the JAX tests' ``_window_batches``)."""
    return slice(max(0, n_updates // every - window + 1) * every, n_updates)


def decayed_np(counts, decay: float):
    """float64 ``Σ decay^(t-i) c_i`` over the leading axis of ``counts`` (one array a batch), in the
    update order the card takes, and the running elementwise maximum (for the float32 bound)."""
    state, peak = None, None
    for c in counts:
        state = c.astype(np.float64) if state is None else decay * state + c
        peak = state.copy() if peak is None else np.maximum(peak, state)
    return state, peak


def decayed_bound(peak: np.ndarray, decay: float) -> np.ndarray:
    """First-order float32 error bound of the decayed sum: two roundings a step (the decay's product
    and the add), each damped by the later decays: ``2 u · max D / (1 - decay)``."""
    return 2.0 * U32 * peak / (1.0 - decay) + U32


def macro_accuracy_np(tp: np.ndarray, fp: np.ndarray, fn: np.ndarray) -> float:
    """float64 ``MulticlassAccuracy(average="macro")``: the mean recall over the classes seen."""
    score = div_np(tp, tp + fn)
    weight = ((tp + fp + fn) > 0).astype(np.float64)
    return float(np.sum(weight * score) / np.sum(weight))


def path_o_data(sizes: dict = O_SIZES) -> dict:
    """Path O's streams: bench.py's online protocol (``bench.py:1742-1871``, seed 29, integers in
    [-6, 6] as float32, then the normals of its lanes 2 and 4 in the order bench.py draws them), a CTR
    model's (score, click) pairs (seed 61: Beta(1.5, 8) scores, a click with the score's probability),
    an image classifier's (pred, target) at 1,000 classes, about 76% correct (seed 63), and path N1's
    lognormal(3, 1) latencies (seed 51) followed by lognormal(3.5, 1) ones (seed 65)."""
    rng = np.random.RandomState(29)
    b = sizes["o1_batch"]
    data = {"o1_stream": np.stack([rng.randint(-6, 7, size=b).astype(np.float32) for _ in range(sizes["o1_batches"])])}
    data["o1_reference"] = rng.normal(0.0, 1.0, 4096).astype(np.float32)
    data["o1_lane2"] = rng.normal(0.0, 1.0, (6, b)).astype(np.float32)
    data["o1_lane4"] = np.concatenate([rng.normal(0.0, 1.0, (10, b)), rng.normal(4.0, 1.0, (10, b))]).astype(np.float32)
    rng = np.random.RandomState(61)
    shape = (sizes["o2_batches"], sizes["o2_batch"])
    data["o2_scores"] = rng.beta(1.5, 8.0, shape).astype(np.float32)
    data["o2_clicks"] = (rng.uniform(0.0, 1.0, shape) < data["o2_scores"]).astype(np.int32)
    rng = np.random.RandomState(63)
    shape, classes = (sizes["o3_batches"], sizes["o3_batch"]), sizes["o3_classes"]
    target = rng.randint(0, classes, shape)
    hit = rng.uniform(0.0, 1.0, shape) < 0.76
    data["o3_preds"] = np.where(hit, target, rng.randint(0, classes, shape)).astype(np.int32)
    data["o3_target"] = target.astype(np.int32)
    shape = (sizes["o4_stationary"], sizes["o4_batch"])
    stationary = np.random.RandomState(51).lognormal(3.0, 1.0, shape)
    shifted = np.random.RandomState(65).lognormal(3.5, 1.0, (sizes["o4_shifted"], sizes["o4_batch"]))
    data["o4_latencies"] = np.concatenate([stationary, shifted]).astype(np.float32)
    return data


def path_o_refs(data: dict, sizes: dict = O_SIZES) -> dict:
    """Path O's numpy side: O2's window bucket counts and decayed binned confmat, O3's window counts and
    decayed counts, O4's window histogram, all in float64."""
    from torchmetrics_tpu_torch.classification import BinaryAUROC

    refs = {}
    decay = float(np.float32(O_DECAY))  # the float32 decay the card multiplies by
    bins = sizes["o2_bins"]
    sl = window_slice(sizes["o2_batches"], sizes["o2_window"], sizes["o2_every"])
    scores, clicks = data["o2_scores"][sl].reshape(-1), data["o2_clicks"][sl].reshape(-1) == 1
    buckets = np.clip(np.floor(scores * np.float32(bins - 1)), 0, bins - 1).astype(np.int64)
    refs["o2_pos"], refs["o2_neg"] = (np.bincount(buckets[k], minlength=bins).astype(np.float64) for k in (clicks, ~clicks))
    thr = BinaryAUROC(thresholds=sizes["o2_thresholds"], device="cpu").thresholds.numpy()
    per_batch = []
    for s, c in zip(data["o2_scores"], data["o2_clicks"]):
        pos, neg = np.sort(s[c == 1]), np.sort(s[c != 1])
        tp = pos.size - np.searchsorted(pos, thr, side="left")
        fp = neg.size - np.searchsorted(neg, thr, side="left")
        per_batch.append(np.stack([np.stack([neg.size - fp, fp], 1), np.stack([pos.size - tp, tp], 1)], 1))
    refs["o2_confmat"], peak = decayed_np(per_batch, decay)
    refs["o2_bound"] = decayed_bound(peak, decay)
    cm = refs["o2_confmat"]
    refs["o2_auroc"] = binned_values_np(cm[:, 1, 1], cm[:, 0, 1], cm[0, 1, 1] + cm[0, 1, 0], cm[0, 0, 0] + cm[0, 0, 1])[0]
    classes = sizes["o3_classes"]

    def counts(preds, target):
        tp = np.bincount(target[preds == target], minlength=classes)
        fp = np.bincount(preds, minlength=classes) - tp
        fn = np.bincount(target, minlength=classes) - tp
        return np.stack([tp, fp, preds.size - tp - fp - fn, fn])  # tp, fp, tn, fn

    sl = window_slice(sizes["o3_batches"], sizes["o3_window"], sizes["o3_every"])
    refs["o3_window"] = counts(data["o3_preds"][sl].reshape(-1), data["o3_target"][sl].reshape(-1))
    refs["o3_value"] = macro_accuracy_np(*refs["o3_window"][[0, 1, 3]])
    refs["o3_decayed"], peak = decayed_np([counts(p, t) for p, t in zip(data["o3_preds"], data["o3_target"])], decay)
    refs["o3_bound"] = decayed_bound(peak, decay)
    refs["o3_decayed_value"] = macro_accuracy_np(*refs["o3_decayed"][[0, 1, 3]])
    n4 = sizes["o4_stationary"] + sizes["o4_shifted"]
    refs["o4_hist"] = stream_hist_np(data["o4_latencies"][window_slice(n4, sizes["o4_window"], sizes["o4_every"])], 64,
                                     0.0, 2000.0)
    return refs


def path_o2_twin(device, data: dict, sizes: dict = O_SIZES):
    """The bits of a fresh sketched ``BinaryAUROC`` fed O2's window batches on the current tier: the
    reference O2's window value must equal, built before path O's launch counts start."""
    from torchmetrics_tpu_torch.classification import BinaryAUROC

    sl = window_slice(sizes["o2_batches"], sizes["o2_window"], sizes["o2_every"])
    fresh = BinaryAUROC(approx="sketch", sketch_bins=sizes["o2_bins"], device=device)
    for s, c in zip(data["o2_scores"][sl], data["o2_clicks"][sl]):
        fresh.update(torch.from_numpy(s).to(device), torch.from_numpy(c).to(device))
    return _bits(fresh.compute())


class PartCounts:
    """One loop's graph-tier bookkeeping (``ops.dispatch.STATS``) and one kernel's launches, as deltas."""

    def __init__(self, counter=None) -> None:
        from torchmetrics_tpu_torch.ops.dispatch import STATS

        self.stats, self.counter = STATS, counter
        self.start = self._now()

    def _now(self):
        s = self.stats
        return (0 if self.counter is None else self.counter.launches, s.warmup_launches, s.captures, s.replays, s.n_fallbacks)

    def delta(self) -> dict:
        keys = ("launches", "warmup_launches", "captures", "replays", "fallbacks")
        return dict(zip(keys, (a - b for a, b in zip(self._now(), self.start))))


def check_part(name: str, tier_name: str, counts: dict, updates: int, captures: int, counted: bool) -> None:
    """One launch an update (the graph tier's warm-ups apart, where they launch the counted kernel),
    and on the graph tier no fallback and ``captures`` captures."""
    if counted and counts["launches"] - counts["warmup_launches"] != updates:
        raise AssertionError(f"{name} ({tier_name} tier): {counts} for {updates} updates; expected one launch each")
    if tier_name == "graph" and (counts["fallbacks"] or counts["captures"] != captures):
        raise AssertionError(f"{name} (graph tier): {counts}; expected no fallback and {captures} captures")
    if tier_name == "eager" and counts["captures"]:
        raise AssertionError(f"{name} (eager tier): {counts}; expected no graph")


def run_path_o1(device, tier_name: str, data: dict, sizes: dict = O_SIZES, clock: float = 0.0):
    """O1, bench.py's online protocol on one tier: lane 1 the updates per second of ``MeanMetric``
    and of ``Windowed(MeanMetric(), 8, advance_every=8)``; lane 2 a manual ``advance`` and one
    ``KsDrift`` evaluation over ``Windowed(StreamingQuantile(q=0.5, capacity=32, levels=12), 4, 2)``
    against 4,096 normals; lane 3 the window value bit-equal to a fresh ``MeanMetric`` fed the
    window's batches through ``update``, ``buffered(4)`` and ``update_batches``; lane 4 a
    ``DriftMonitor`` with one KS spec (threshold 0.2, windows ``((5.0, 1.0),)``, the clock +1 s an
    update), quiet over 10 stationary batches and firing, with one "burning" warning, over 10
    batches shifted by +4. Returns (values, {name: line})."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.online import DriftMonitor, DriftSpec, KsDrift, Windowed

    values, lines = {}, {}
    window, every = sizes["o1_window"], sizes["o1_every"]
    stream = torch.from_numpy(data["o1_stream"]).to(device)
    batches = [(b,) for b in stream]

    def rate(metric, label):
        for b in stream[:8]:
            metric.update(b)
        log = StepLog(label, tier_name)
        _, seconds = loop(log, metric.update, batches)
        return len(batches) / seconds, log

    plain, plain_log = rate(tm.MeanMetric(device=device), "path O1 MeanMetric")
    windowed, windowed_log = rate(tm.Windowed(tm.MeanMetric(device=device), window, advance_every=every, emit=False),
                                  "path O1 Windowed(MeanMetric)")
    lines["lane 1"] = (f"{len(batches)} updates of {stream.shape[1]:,}: MeanMetric {plain:.6g} updates/s ({plain_log.line()});"
                       f" Windowed(MeanMetric(), {window}, advance_every={every}) {windowed:.6g} updates/s"
                       f" ({windowed_log.line()}); windowed/plain time per update {plain / windowed:.4f}, JAX's stated"
                       " bound 1.5")
    advancing = Windowed(tm.SumMetric(device=device), window, advance_every=None, emit=False)
    advancing.update(stream[0])
    advancing.advance()
    sync()
    t0 = time.perf_counter()
    for _ in range(32):
        advancing.advance()
    sync()
    advance_us = (time.perf_counter() - t0) / 32 * 1e6
    quantile = Windowed(tm.StreamingQuantile(q=0.5, capacity=32, levels=12, device=device), 4, advance_every=2, emit=False)
    for b in torch.from_numpy(data["o1_lane2"]).to(device):
        quantile.update(b)
    detector = KsDrift(quantile, data["o1_reference"])
    detector.score()
    t0 = time.perf_counter()
    for _ in range(16):
        score = detector.score()
    detector_us = (time.perf_counter() - t0) / 16 * 1e6
    lines["lane 2"] = f"manual advance {advance_us:.2f} us; KsDrift evaluation {detector_us:.1f} us (score {score:.6f})"
    values["o1 lane 2"] = score
    direct = tm.MeanMetric(device=device)
    for b in stream[window_slice(len(batches), window, every)]:
        direct.update(b)
    want = _bits(direct.compute())
    for how in ("update", "buffered", "update_batches"):
        m = Windowed(tm.MeanMetric(device=device), window, advance_every=every, emit=False)
        if how == "buffered":
            with m.buffered(4) as buf:
                for b in stream:
                    buf.update(b)
        elif how == "update_batches":
            m.update_batches(stream)
        else:
            for b in stream:
                m.update(b)
        if _bits(m.compute()) != want:
            raise AssertionError(f"path O1 lane 3 ({tier_name} tier, {how}): the window value differs from a fresh"
                                 " MeanMetric fed the window's batches")
    values["o1 lane 3"] = want
    lines["lane 3"] = "the window value bit-equal to a fresh MeanMetric over the window's batches through update, buffered(4)" \
                      " and update_batches"
    drifting = Windowed(tm.StreamingQuantile(q=0.5, capacity=32, levels=12, device=device), 4, advance_every=2, emit=False)
    name = f"o1-drift-{tier_name}"
    monitor = DriftMonitor([DriftSpec(name=name, detector=KsDrift(drifting, data["o1_reference"]), threshold=0.2,
                                      windows=((5.0, 1.0),))])
    verdicts = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i, b in enumerate(torch.from_numpy(data["o1_lane4"]).to(device)):
            drifting.update(b)
            (status,) = monitor.evaluate(now=clock + i + 1.0)
            verdicts.append((status.drifting, status.score))
            if i == 9 and [str(w.message) for w in caught if "burning" in str(w.message)]:
                raise AssertionError(f"path O1 lane 4 ({tier_name} tier): a burning warning over the stationary batches")
    fired = [str(w.message) for w in caught if "burning" in str(w.message)]
    if any(d for d, _ in verdicts[:10]) or not verdicts[-1][0] or len(fired) != 1:
        raise AssertionError(f"path O1 lane 4 ({tier_name} tier): verdicts {verdicts}, {len(fired)} burning warnings")
    values["o1 lane 4"] = verdicts
    lines["lane 4"] = (f"quiet over the 10 stationary batches (KS up to {max(s for _, s in verdicts[:10]):.4f}), firing from"
                       f" batch {next(i for i, (d, _) in enumerate(verdicts) if d)} of 20 with one warning (final KS"
                       f" {verdicts[-1][1]:.4f})")
    return values, lines


def run_path_o2(device, tier_name: str, data: dict, refs: dict, sizes: dict = O_SIZES):
    """O2, a CTR model's live quality on one tier: ``Windowed(BinaryAUROC(approx="sketch",
    sketch_bins=2048), 12, advance_every=10)`` (one K2 ``sketch_update`` an update; the merged histogram
    pair numpy's bucket counts of the window's batches exactly; the value bit-equal to a fresh sketched
    ``BinaryAUROC`` fed those batches; the ``online.BinaryAUROC.w12`` series one point an advance, the
    last the value) and ``Ema(BinaryAUROC(thresholds=200), decay=0.99)`` (one K3 ``binned_confmat`` an
    update; the confmat within the float32 bound of numpy's decayed counts, the value within 1e-5). The
    fresh metric's bits are ``refs["o2_twin"][tier_name]`` (``path_o2_twin``), made before the counts."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch import obs
    from torchmetrics_tpu_torch.classification import BinaryAUROC
    from torchmetrics_tpu_torch.ops import curve_counts as k3
    from torchmetrics_tpu_torch.ops import hist_pair as k2

    values, lines = {}, {}
    scores, clicks = (torch.from_numpy(data[k]).to(device) for k in ("o2_scores", "o2_clicks"))
    n, window, every = scores.shape[0], sizes["o2_window"], sizes["o2_every"]
    batches = list(zip(scores, clicks))
    w = tm.Windowed(BinaryAUROC(approx="sketch", sketch_bins=sizes["o2_bins"], device=device), window, advance_every=every)
    part = PartCounts(on_card(device, k2.SKETCH_UPDATE))
    log = StepLog("path O2 Windowed sketched BinaryAUROC", tier_name)
    _, seconds = loop(log, w.update, batches)
    check_part("path O2 Windowed sketched BinaryAUROC", tier_name, part.delta(), n, 2, on_card(device, k2.SKETCH_UPDATE))
    state = w.window_state()
    for key in ("pos", "neg"):
        if not np.array_equal(state[f"{key}_hist"].double().cpu().numpy(), refs[f"o2_{key}"]):
            raise AssertionError(f"path O2 ({tier_name} tier): the window's {key}_hist differs from numpy's bucket counts")
    value = w.compute()
    if _bits(value) != refs["o2_twin"][tier_name]:
        raise AssertionError(f"path O2 ({tier_name} tier): the window's AUROC {float(value)} is not a fresh metric's bits")
    series = obs.telemetry.get_series(w.series_name)
    if series is None or series.count != n // every or series.last != float(value):
        raise AssertionError(f"path O2 ({tier_name} tier): the series {w.series_name} is {series!r}, expected"
                             f" {n // every} points ending at {float(value)}")
    values["window"] = _bits(state)
    lines["Windowed sketched BinaryAUROC"] = (f"{n} updates of {scores.shape[1]:,}: {scores.numel() / seconds:.5g} pairs/s,"
                                             f" {log.line()}; the window's AUROC {float(value):.6f}, bit-equal to a fresh"
                                             f" sketch of its {len(batches[window_slice(n, window, every)])} batches,"
                                             f" {series.count} emitted points")
    ema = tm.Ema(BinaryAUROC(thresholds=sizes["o2_thresholds"], device=device), decay=O_DECAY)
    part = PartCounts(on_card(device, k3.BINNED_CONFMAT))
    log = StepLog("path O2 Ema binned BinaryAUROC", tier_name)
    _, seconds = loop(log, ema.update, batches)
    check_part("path O2 Ema binned BinaryAUROC", tier_name, part.delta(), n, 1, on_card(device, k3.BINNED_CONFMAT))
    confmat = ema.metric_state["confmat"].double().cpu().numpy()
    err = np.abs(confmat - refs["o2_confmat"])
    if not np.all(err <= refs["o2_bound"]):
        raise AssertionError(f"path O2 Ema ({tier_name} tier): confmat off numpy's decayed counts by up to {err.max()}"
                             f" beyond the float32 bound")
    auroc_err = check_rel(f"path O2 Ema AUROC ({tier_name} tier)", ema.compute(), refs["o2_auroc"], tol=0.0, bound=O_TOL)
    values["ema"] = _bits(ema.metric_state["confmat"])
    lines["Ema binned BinaryAUROC"] = (f"{n} updates: {scores.numel() / seconds:.5g} pairs/s, {log.line()}; confmat within"
                                      f" the float32 bound of numpy's decayed counts (largest error {err.max():.4g}, bound"
                                      f" {refs['o2_bound'].max():.4g}); AUROC {float(ema.compute()):.6f}, {auroc_err:.3g}"
                                      " from numpy's")
    return values, lines


def run_path_o3(device, tier_name: str, data: dict, refs: dict, sizes: dict = O_SIZES):
    """O3, an image classifier's sliding top-1 at ImageNet-1k's width on one tier:
    ``Windowed(MulticlassAccuracy(num_classes=1000), 12, advance_every=10)`` (one K1 launch an update; the
    merged tp/fp/tn/fn numpy's window counts exactly; the value within 1e-6 of float64 numpy's) and
    ``Ema(MulticlassAccuracy(num_classes=1000), decay=0.99)`` (float32 states within the float32 bound of
    numpy's decayed counts, none truncated)."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch.classification import MulticlassAccuracy
    from torchmetrics_tpu_torch.ops import bincount as k1

    values, lines = {}, {}
    preds, target = (torch.from_numpy(data[k]).to(device) for k in ("o3_preds", "o3_target"))
    n, classes = preds.shape[0], sizes["o3_classes"]
    batches = list(zip(preds, target))
    w = tm.Windowed(MulticlassAccuracy(num_classes=classes, device=device), sizes["o3_window"],
                    advance_every=sizes["o3_every"])
    part = PartCounts(on_card(device, k1.BINCOUNT))
    log = StepLog("path O3 Windowed MulticlassAccuracy", tier_name)
    _, seconds = loop(log, w.update, batches)
    check_part("path O3 Windowed MulticlassAccuracy", tier_name, part.delta(), n, 2, on_card(device, k1.BINCOUNT))
    state = w.window_state()
    for i, key in enumerate(("tp", "fp", "tn", "fn")):
        if state[key].dtype != torch.int64 or not np.array_equal(state[key].cpu().numpy(), refs["o3_window"][i]):
            raise AssertionError(f"path O3 ({tier_name} tier): the window's {key} differs from numpy's counts")
    err = check_rel(f"path O3 window accuracy ({tier_name} tier)", w.compute(), refs["o3_value"], tol=0.0, bound=1e-6)
    values["window"] = _bits(state)
    lines["Windowed MulticlassAccuracy"] = (f"{n} updates of {preds.shape[1]:,}: {preds.numel() / seconds:.5g} samples/s,"
                                           f" {log.line()}; window counts numpy's, macro accuracy {float(w.compute()):.6f}"
                                           f" ({err:.3g} from float64 numpy's)")
    ema = tm.Ema(MulticlassAccuracy(num_classes=classes, device=device), decay=O_DECAY)
    part = PartCounts(on_card(device, k1.BINCOUNT))
    log = StepLog("path O3 Ema MulticlassAccuracy", tier_name)
    _, seconds = loop(log, ema.update, batches)
    check_part("path O3 Ema MulticlassAccuracy", tier_name, part.delta(), n, 1, on_card(device, k1.BINCOUNT))
    fraction, worst = 0.0, 0.0
    for i, key in enumerate(("tp", "fp", "tn", "fn")):
        got = ema.metric_state[key]
        if got.dtype != torch.float32:
            raise AssertionError(f"path O3 Ema ({tier_name} tier): state {key} is {got.dtype}, not float32")
        got = got.double().cpu().numpy()
        gap = np.abs(got - refs["o3_decayed"][i])
        if not np.all(gap <= refs["o3_bound"][i]):
            raise AssertionError(f"path O3 Ema ({tier_name} tier): {key} off numpy's decayed counts by up to {gap.max()}")
        worst = max(worst, float(gap.max()))
        fraction = max(fraction, float(np.max(np.abs(got - np.round(got)))))
    if fraction == 0.0:
        raise AssertionError(f"path O3 Ema ({tier_name} tier): every decayed count is whole: the counts were truncated")
    value_err = check_rel(f"path O3 Ema accuracy ({tier_name} tier)", ema.compute(), refs["o3_decayed_value"], tol=0.0,
                          bound=O_TOL)
    values["ema"] = _bits(ema.metric_state)
    lines["Ema MulticlassAccuracy"] = (f"{n} updates: {preds.numel() / seconds:.5g} samples/s, {log.line()}; float32 states"
                                      f" within the float32 bound of numpy's decayed counts (largest error {worst:.4g}),"
                                      f" largest fractional part {fraction:.4f}; accuracy {float(ema.compute()):.6f}"
                                      f" ({value_err:.3g} from numpy's)")
    return values, lines


def run_path_o4(device, tier_name: str, data: dict, refs: dict, sizes: dict = O_SIZES, clock: float = 0.0):
    """O4, latency drift on a serving dashboard on one tier: path N1's lognormal(3, 1) latencies, then
    lognormal(3.5, 1) ones, through ``Windowed(StreamingQuantile(q=(0.5, 0.9, 0.99)), 12,
    advance_every=5)`` watched by ``DriftMonitor(default_drift_specs(...))`` against the first 10
    batches (KS at 0.1 and PSI at 0.05, windows ``((5.0, 1.0),)``, evaluated after each update with
    the clock +1 s an update): both quiet over the stationary part, each firing once after the shift,
    the stock specs (KS 0.15, PSI 0.25) in the same monitor quiet throughout, the counters what the
    verdicts imply; the window's KLL state bit-equal to ``kll_merge_stacked`` of
    per-sub-window sketches in ring order; the host KS within 1e-6 of ``kll_ks_distance`` on the device;
    ``Windowed(StreamingHistogram(bins=64, lo=0, hi=2000), 12, advance_every=5)`` numpy's counts (one K2
    ``hist_pair`` an update); ``EwmaBand(alpha=0.1, warmup=5)`` over the emitted p99 (the scalar
    ``Windowed(StreamingQuantile(q=0.99), 12, 5)``'s series) under 3 before the shift and above after;
    the emitted ``online.*`` series folded on the device, one point an advance, their median within the
    KLL rank bound of ``np.sort`` over the emitted values."""
    import torchmetrics_tpu_torch as tm
    from torchmetrics_tpu_torch import obs
    from torchmetrics_tpu_torch.online import DriftMonitor, EwmaBand, default_drift_specs
    from torchmetrics_tpu_torch.online.drift import _as_points, _window_points, ks_distance_points
    from torchmetrics_tpu_torch.ops import hist_pair as k2
    from torchmetrics_tpu_torch.sketch import kll

    values, lines = {}, {}
    stream = torch.from_numpy(data["o4_latencies"]).to(device)
    n, window, every = stream.shape[0], sizes["o4_window"], sizes["o4_every"]
    stationary = sizes["o4_stationary"]
    reference = data["o4_latencies"][:sizes["o4_reference"]].reshape(-1)
    w = tm.Windowed(tm.StreamingQuantile(q=(0.5, 0.9, 0.99), device=device), window, advance_every=every)
    p99 = tm.Windowed(tm.StreamingQuantile(q=0.99, device=device), window, advance_every=every,
                      series="online.latency_p99.w12")
    hist = tm.Windowed(tm.StreamingHistogram(bins=64, lo=0.0, hi=2000.0, device=device), window, advance_every=every,
                       emit=False)
    specs = default_drift_specs(w, reference, name=f"o4-latency-{tier_name}", ks_threshold=O4_KS_THRESHOLD,
                                psi_threshold=O4_PSI_THRESHOLD, windows=((5.0, 1.0),))
    # the stock thresholds watch the same window in the same monitor, which reads it once an evaluation
    stock = default_drift_specs(w, reference, name=f"o4-stock-{tier_name}", windows=((5.0, 1.0),))
    monitor = DriftMonitor(specs + stock)
    transitions, band, band_scores, verdicts = [], EwmaBand(alpha=0.1, warmup=5), [], []
    monitor.subscribe(lambda status, firing: transitions.append((status.spec.name, firing)))
    names = ("drift.evaluations", "drift.alarms", "slo.alarms", "online.emit_skipped")
    before = {c: obs.telemetry.counter(c).value for c in names}
    part = PartCounts(on_card(device, k2.HIST_PAIR))
    eval_s = 0.0
    log = StepLog("path O4 three windows", tier_name)

    def step(batch):
        w.update(batch)
        p99.update(batch)
        hist.update(batch)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i, batch in enumerate(stream):
            log(step, batch)
            t0 = time.perf_counter()
            statuses = monitor.evaluate(now=clock + i + 1.0)
            eval_s += time.perf_counter() - t0
            verdicts.append([(s.drifting, s.score) for s in statuses])
            if (i + 1) % every == 0:
                band_scores.append(band.observe(obs.telemetry.get_series(p99.series_name).last))
            if i + 1 == stationary and [w_ for w_ in caught if "burning" in str(w_.message)]:
                raise AssertionError(f"path O4 ({tier_name} tier): a burning warning over the stationary part")
    counts = part.delta()
    fired = [str(x.message) for x in caught if "burning" in str(x.message)]
    spec_names = [s.name for s in specs]
    ours = sorted(t for t in transitions if t[0] in spec_names)
    if any(d for v in verdicts[:stationary] for d, _ in v) or ours != sorted((s, True) for s in spec_names) \
            or sorted(sum(f"'{s}'" in f for f in fired) for s in spec_names) != [1, 1]:
        raise AssertionError(f"path O4 ({tier_name} tier): transitions {transitions}, warnings {fired}; each spec must"
                             " stay quiet over the stationary part and fire exactly once after the shift")
    stock_peak = [max(v[k][1] for v in verdicts) for k in range(len(specs), len(specs) + len(stock))]
    scores = [[sc for _, sc in v] for v in verdicts]
    if any(v[:len(specs)] != v[len(specs):] for v in scores):
        raise AssertionError(f"path O4 ({tier_name} tier): the stock specs scored the window otherwise than the others")
    if sizes["o4_stock_quiet"] and (any(d for v in verdicts for d, _ in v[len(specs):]) or len(fired) != 2
                                    or len(transitions) != 2):
        raise AssertionError(f"path O4 ({tier_name} tier): the stock specs fired (peaks {stock_peak}, thresholds"
                             f" {[s.threshold for s in stock]}); quiet over this shift expected")
    burning = sum(d for v in verdicts for d, _ in v)
    deltas = {c: obs.telemetry.counter(c).value - before[c] for c in names}
    want = {"drift.evaluations": n * (len(specs) + len(stock)), "drift.alarms": burning, "slo.alarms": burning,
            "online.emit_skipped": n // every}
    if deltas != want:
        raise AssertionError(f"path O4 ({tier_name} tier): counters {deltas}, the verdicts imply {want}")
    # captures: the three updates, the two emitting windows' values and the monitor's window_state
    check_part("path O4 Windowed StreamingHistogram", tier_name, counts, n, 6, on_card(device, k2.HIST_PAIR))
    if not np.array_equal(hist.compute().double().cpu().numpy(), refs["o4_hist"]):
        raise AssertionError(f"path O4 ({tier_name} tier): the window's histogram differs from numpy's counts")
    # the ring in slot order: sub-window j sits in slot j % window; the live slot is empty after the last advance
    live = range(max(0, n // every - window + 1), n // every + 1)
    slots = [kll.kll_init().to(device)] * window
    for j in live:
        part_q = tm.StreamingQuantile(device=device)
        for batch in stream[j * every:(j + 1) * every]:
            part_q.update(batch)
        slots[j % window] = part_q.metric_state["sketch"]
    window_sketch = w.window_state()["sketch"]
    if not torch.equal(window_sketch, kll.kll_merge_stacked(torch.stack(slots))):
        raise AssertionError(f"path O4 ({tier_name} tier): the window's KLL state is not the stacked merge of its"
                             " sub-windows' sketches")
    ref_q = tm.StreamingQuantile(device=device)
    for batch in stream[:sizes["o4_reference"]]:
        ref_q.update(batch)
    ref_sketch = ref_q.metric_state["sketch"]
    on_device = float(kll.kll_ks_distance(window_sketch, ref_sketch))
    on_host = ks_distance_points(_as_points(window_sketch), _as_points(ref_sketch))
    if abs(on_device - on_host) > 1e-6:
        raise AssertionError(f"path O4 ({tier_name} tier): host KS {on_host} vs the device's kll_ks_distance {on_device}")
    advances_before = stationary // every
    calm = [s for s in band_scores[:advances_before] if s is not None]
    if max(calm) >= 3.0 or max(s for s in band_scores[advances_before:]) <= 3.0:
        raise AssertionError(f"path O4 ({tier_name} tier): EWMA band scores {band_scores}; under 3 before the shift and"
                             " above after, expected")
    series_lines = []
    for name in obs.telemetry.series_names():
        if not name.startswith("online."):
            continue
        series = obs.telemetry.get_series(name)
        emitted = np.sort(np.asarray(series.window(float("inf"))))
        series.flush()
        median = series.quantile(0.5)
        err = rank_error_np(emitted, [median], [0.5])
        if series.sketch.device != torch.device(device) or err > kll.DEFAULT_RANK_ERROR:
            raise AssertionError(f"path O4 ({tier_name} tier): series {name} folded on {series.sketch.device}, its median"
                                 f" {median} off by rank {err}")
        series_lines.append(f"{name} {series.count} points, median {median:.6g}")
    if obs.telemetry.get_series(p99.series_name).count != n // every:
        raise AssertionError(f"path O4 ({tier_name} tier): the p99 series holds {obs.telemetry.get_series(p99.series_name).count}"
                             f" points for {n // every} advances")
    # the monitor's one read of the window against each detector reading it on its own
    sync()
    t0 = time.perf_counter()
    own = [s.detector.score() for s in monitor.specs]
    own_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    points = _window_points(w, "sketch")
    shared = [s.detector.score_points(points) for s in monitor.specs]
    shared_ms = (time.perf_counter() - t0) * 1e3
    if own != shared:
        raise AssertionError(f"path O4 ({tier_name} tier): scores from one shared read {shared}, from one read each {own}")
    values.update(window=_bits(window_sketch), hist=_bits(hist.compute()), verdicts=verdicts, band=band_scores)
    first = [next(i for i, v in enumerate(verdicts) if v[k][0]) for k in range(len(specs))]
    lines["drift"] = (f"{n} updates of {stream.shape[1]:,} latencies: {stream.numel() / sum(log.seconds):.5g} latencies/s"
                      f" through three windows ({log.line()}), DriftMonitor.evaluate {eval_s / n * 1e3:.3f} ms each; KS and PSI"
                      f" quiet over the {stationary} stationary batches (largest {max(v[0][1] for v in verdicts[:stationary]):.4f},"
                      f" {max(v[1][1] for v in verdicts[:stationary]):.4f}), firing at batches {first} (final"
                      f" {verdicts[-1][0][1]:.4f}, {verdicts[-1][1][1]:.4f}), one warning each; the stock specs (KS"
                      f" {stock[0].threshold:g}, PSI {stock[1].threshold:g}) quiet throughout (peaks {stock_peak[0]:.4f},"
                      f" {stock_peak[1]:.4f}); counters {deltas}; the {len(monitor.specs)} scores from one read of the"
                      f" window {shared_ms:.3f} ms, from one read each {own_ms:.3f} ms")
    lines["window"] = (f"the window's KLL state bit-equal to the stacked merge of its sub-windows' sketches; host KS"
                       f" {on_host:.9f} vs kll_ks_distance {on_device:.9f}; histogram numpy's counts; EWMA band over the"
                       f" p99 up to {max(calm):.3f} before the shift, {max(s for s in band_scores[advances_before:]):.1f}"
                       f" after; series folded on the device: {'; '.join(series_lines)}")
    return values, lines


def host_aten_ops(step, batches) -> float:
    """Host aten operations per call of ``step`` over ``batches``, as ``profile_port.py`` counts them."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=activities) as prof:
        for batch in batches:
            step(*batch)
    return sum(k.count for k in prof.key_averages() if k.key.startswith("aten::")) / len(batches)


def run_path_o5(device, tier_name: str, sizes: dict = O_SIZES):
    """O5, the engine's telemetry on path A's collection (C = 5, seed 0) on one tier: ``o5_steps``
    forward steps under ``obs.enabled()``: the group leader's ``Metric.telemetry`` shows one forward
    call a step, one capture per signature on the graph tier and one retrace after a change of batch
    size, dispatches equal to the graph replays, one span per call. Then, on the card with telemetry
    off, path A's graph step: its wall and host aten operations, the same as with telemetry on."""
    from torchmetrics_tpu_torch import obs
    from torchmetrics_tpu_torch.ops.dispatch import STATS

    values, lines = {}, {}
    rng = np.random.RandomState(0)
    steps, batch = sizes["o5_steps"], sizes["o5_batch"]
    pa, ta = (torch.from_numpy(rng.randint(0, 5, steps * batch).astype(np.int32)).to(device) for _ in range(2))
    batches = [(pa[i * batch:(i + 1) * batch], ta[i * batch:(i + 1) * batch]) for i in range(steps)]
    mc = collection(5, validate_args=False, device=device)
    replays, n_events = STATS.replays, len(obs.telemetry.events())
    with obs.enabled():
        for b in batches:
            mc(*b)
        snap = mc.telemetry
        mc(pa[:batch // 2], ta[:batch // 2])
    after = mc.telemetry
    leader = mc.compute_groups[0][0]
    calls = snap["metrics"][leader]["calls"]
    if calls.get("forward", 0) + calls.get("group_forward", 0) != steps or len(mc.compute_groups) != 1:
        raise AssertionError(f"path O5 ({tier_name} tier): the leader's calls {calls} over {steps} steps")
    traces = {name: t["traces"] for name, t in after["metrics"].items()}
    want_traces = {name: ({"forward": 1, "group_forward": 2} if name == leader else {"forward": 1}) for name in traces}
    if tier_name == "eager":
        want_traces = {name: {} for name in traces}
    if traces != want_traces or after["retraces_total"] != (1 if tier_name == "graph" else 0):
        raise AssertionError(f"path O5 ({tier_name} tier): captures {traces}, retraces {after['retraces_total']}")
    total_calls = sum(sum(t["calls"].values()) for t in after["metrics"].values())
    dispatches = after["dispatches"]
    if (tier_name == "graph" and dispatches != STATS.replays - replays) or dispatches != total_calls:
        raise AssertionError(f"path O5 ({tier_name} tier): {dispatches} dispatches, {STATS.replays - replays} replays,"
                             f" {total_calls} calls")
    spans = [e for e in obs.telemetry.events()[n_events:] if e["cat"] == "metric" and e["ph"] == "X"]
    if len(spans) != total_calls:
        raise AssertionError(f"path O5 ({tier_name} tier): {len(spans)} spans for {total_calls} calls")
    values["telemetry"] = (calls, traces, dispatches, len(spans))
    lines["telemetry"] = (f"{steps + 1} steps under obs.enabled(): leader {leader} calls {after['metrics'][leader]['calls']},"
                          f" captures {traces[leader]}, {dispatches} dispatches = {STATS.replays - replays} graph replays,"
                          f" {len(spans)} spans")
    if tier_name == "graph" and torch.device(device).type == "cuda":
        quiet = collection(5, validate_args=False, device=device)
        for b in batches[:5]:
            quiet(*b)
        log = StepLog("path A with telemetry off", tier_name)
        loop(log, quiet, batches[5:])
        off = host_aten_ops(quiet, batches[5:])
        with obs.enabled():
            on = host_aten_ops(quiet, batches[5:])
        if off != on or off != 13:
            raise AssertionError(f"path O5: path A's graph step has {off} host aten operations with telemetry off and {on}"
                                 " with it on; 13 expected")
        lines["path A"] = (f"path A's graph step with telemetry off: {log.line()}; {off:g} host aten operations a step ({on:g}"
                           " with telemetry on)")
    return values, lines


def run_path_o(device, card: str, sizes: dict = O_SIZES):
    """Path O on both tiers: the data, the numpy side and O2's fresh twins first, then every kernel's
    count set to 0, then O1-O5 on the graph tier and on the eager tier, each tier with a fresh telemetry
    registry and flight ring, bit-equal where the window is exact; O2 must launch K2's ``sketch_update`` and K3, O3 and O5 K1,
    O4 K2's ``hist_pair``, O1 none. Returns the graph tier's launches of K1, K2 and K3."""
    from torchmetrics_tpu_torch import obs
    from torchmetrics_tpu_torch.obs import flightrec
    from torchmetrics_tpu_torch.ops.bincount import LaunchCounter

    started_o = time.perf_counter()
    data = path_o_data(sizes)
    refs = path_o_refs(data, sizes)
    refs["o2_twin"] = {}
    for tier_name in ("graph", "eager"):
        with tier(tier_name):
            refs["o2_twin"][tier_name] = path_o2_twin(device, data, sizes)
    print(f"path O: data, numpy side and O2's fresh twins in {time.perf_counter() - started_o:.1f} s")
    for counter in LaunchCounter.ALL:
        counter.launches = 0
    res_o, launches_o = {}, {}
    for t_index, tier_name in enumerate(("graph", "eager")):
        with tier(tier_name):
            obs.telemetry.reset()
            flightrec.clear()
            r = res_o[tier_name] = {}
            for part in ("O1", "O2", "O3", "O4", "O5"):
                before = {k: c.launches for k, c in kernel_counters().items()}
                t_part = time.perf_counter()
                clock = 10_000.0 * (t_index + 1)
                if part == "O1":
                    r[part], lines_o = run_path_o1(device, tier_name, data, sizes, clock)
                elif part == "O2":
                    r[part], lines_o = run_path_o2(device, tier_name, data, refs, sizes)
                elif part == "O3":
                    r[part], lines_o = run_path_o3(device, tier_name, data, refs, sizes)
                elif part == "O4":
                    r[part], lines_o = run_path_o4(device, tier_name, data, refs, sizes, clock)
                else:
                    r[part], lines_o = run_path_o5(device, tier_name, sizes)
                launches_o[(tier_name, part)] = {k: c.launches - before[k] for k, c in kernel_counters().items()}
                for label, line in lines_o.items():
                    print(f"path {part} [{card}] {label}, {tier_name} tier: {line}")
                print(f"path {part} [{card}] {tier_name} tier: {time.perf_counter() - t_part:.1f} s, kernel launches"
                      f" {launches_o[(tier_name, part)]}")
    for part in ("O1", "O2", "O3", "O4"):  # O5's values hold tier-specific captures
        same_on_both_tiers(f"path {part}", res_o["graph"][part], res_o["eager"][part])
    if torch.device(device).type == "cuda":
        for (tier_name, part), counts in launches_o.items():
            must = {"O1": (), "O2": ("K2 sketch_update", "K3 binned_confmat"), "O3": ("K1",), "O4": ("K2 hist_pair",),
                    "O5": ("K1",)}[part]
            idle = [k for k, c in counts.items() if k not in must and c]
            if any(counts[k] == 0 for k in must) or idle:
                raise AssertionError(f"path {part} ({tier_name} tier): a kernel of the part launched no time, or another"
                                     f" launched: {counts}")
    graph = [c for (t, _), c in launches_o.items() if t == "graph"]
    launches = {k: sum(c[k] for c in graph) for k in ("K1", "K2 hist_pair", "K2 sketch_update", "K3 binned_confmat")}
    print(f"path O [{card}]: both tiers bit-equal where the window is exact; graph tier launches {launches};"
          f" {time.perf_counter() - started_o:.1f} s")
    return launches


P_TOL = 1e-5
#: SSIM, MS-SSIM, UQI and VIF: absolute, the bound of the JAX package's own tests (``tests/unittests/image/test_image.py:56``)
P_WINDOW_TOL = 1e-4
#: PSNR and PSNR-B: relative
P_PSNR_TOL = 1e-4
#: path P's full sizes; the tests pass smaller ones. P1 at the Kodak set's shape, P2 at CAVE's, P3 at
#: BERT-base's width; ``p3_sample`` rows of each matrix are held to float64, ``threads`` host threads
#: compute the float64 side (scipy.ndimage and numpy release the GIL)
P_SIZES = {"p1_images": 24, "p1_batch": 8, "p1_hw": (512, 768), "p2_scenes": 4, "p2_batch": 2, "p2_bands": 31,
           "p2_hw": (512, 512), "p3_rows": 8192, "p3_l1_rows": 4096, "p3_dim": 768, "p3_sample": 256,
           "ms_betas": (0.0448, 0.2856, 0.3001, 0.2363, 0.1333), "threads": 8}
#: SSIM's and UQI's gaussian window (11 taps, sigma 1.5), as float64 1-D weights
P_GAUSS = (11, 1.5)


def pmap(fn, items, threads: int) -> list:
    """``[fn(item) for item in items]`` in ``threads`` host threads."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(fn, items))


def gauss_np(k: int, sigma: float) -> np.ndarray:
    d = np.arange(k) - (k - 1) / 2
    g = np.exp(-((d / sigma) ** 2) / 2)
    return g / g.sum()


def valid_np(x: np.ndarray, w: np.ndarray, stride: int = 1) -> np.ndarray:
    """The separable 'valid' correlation of the last two axes of float64 ``x`` with the 1-D weights
    ``w`` (odd length): the window fully inside the image, which is what the port's reflect-padded
    convolution keeps after its crop."""
    from scipy import ndimage

    h = len(w) // 2
    y = ndimage.correlate1d(x, w, axis=-2, mode="constant")
    y = ndimage.correlate1d(y, w, axis=-1, mode="constant")
    return y[..., h:x.shape[-2] - h:stride, h:x.shape[-1] - h:stride]


def pool_np(x: np.ndarray) -> np.ndarray:
    """2 x 2 means, floor semantics."""
    n, c, hh, ww = x.shape
    return x[:, :, :hh // 2 * 2, :ww // 2 * 2].reshape(n, c, hh // 2, 2, ww // 2, 2).mean(axis=(3, 5))


def ssim_parts_np(p: np.ndarray, t: np.ndarray, data_range: float, k1: float = 0.01, k2: float = 0.03):
    """One image's ``(C, H, W)`` SSIM and contrast-sensitivity means and its UQI sum, in float64."""
    w = gauss_np(*P_GAUSS)
    mu_p, mu_t = valid_np(p, w), valid_np(t, w)
    s_pp, s_tt, s_pt = valid_np(p * p, w) - mu_p * mu_p, valid_np(t * t, w) - mu_t * mu_t, valid_np(p * t, w) - mu_p * mu_t
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    upper, lower = 2 * s_pt + c2, s_pp + s_tt + c2
    ssim = ((2 * mu_p * mu_t + c1) * upper) / ((mu_p * mu_p + mu_t * mu_t + c1) * lower)
    uqi = (4 * mu_p * mu_t * s_pt) / ((mu_p * mu_p + mu_t * mu_t) * (s_pp + s_tt) + 2.0 ** -23)
    return ssim.mean(), (upper / lower).mean(), uqi.sum(), uqi.size


def ms_ssim_np(p: np.ndarray, t: np.ndarray, betas, threads: int) -> np.ndarray:
    """Per-image MS-SSIM of one batch with ``data_range=None`` (the batch's range at each scale) and
    ``normalize="relu"``."""
    mcs = []
    for scale in range(len(betas)):
        dr = max(p.max() - p.min(), t.max() - t.min())
        parts = pmap(lambda i: ssim_parts_np(p[i], t[i], dr), range(len(p)), threads)
        sim, cs = np.maximum([x[0] for x in parts], 0), np.maximum([x[1] for x in parts], 0)
        mcs.append(cs)
        if scale != len(betas) - 1:
            p, t = pool_np(p), pool_np(t)
    mcs[-1] = sim
    return np.prod([m ** b for m, b in zip(mcs, betas)], axis=0)


def vif_np(p: np.ndarray, t: np.ndarray, sigma_n_sq: float = 2.0) -> float:
    """One image's VIF, the mean over its channels; the 2-D gaussian of each scale is separable."""
    eps, num, den = 1e-10, np.zeros(p.shape[0]), np.zeros(p.shape[0])
    for scale in range(4):
        k = int(2.0 ** (4 - scale) + 1)
        w = gauss_np(k, k / 5)
        if scale > 0:
            t, p = valid_np(t, w, 2), valid_np(p, w, 2)
        mu_t, mu_p = valid_np(t, w), valid_np(p, w)
        s_tt = np.maximum(valid_np(t * t, w) - mu_t ** 2, 0)
        s_pp = np.maximum(valid_np(p * p, w) - mu_p ** 2, 0)
        s_tp = valid_np(t * p, w) - mu_t * mu_p
        g = s_tp / (s_tt + eps)
        s_v = s_pp - g * s_tp
        m = s_tt < eps
        g, s_v, s_tt = np.where(m, 0, g), np.where(m, s_pp, s_v), np.where(m, 0, s_tt)
        m = s_pp < eps
        g, s_v = np.where(m, 0, g), np.where(m, 0, s_v)
        m = g < 0
        s_v, g = np.where(m, s_pp, s_v), np.where(m, 0, g)
        s_v = np.maximum(s_v, eps)
        num += np.log10(1 + g * g * s_tt / (s_v + sigma_n_sq)).reshape(len(num), -1).sum(1)
        den += np.log10(1 + s_tt / sigma_n_sq).reshape(len(den), -1).sum(1)
    return float(np.mean(num / den))


def box_np(x: np.ndarray, k: int, crop: int) -> np.ndarray:
    """Means over the ``k x k`` windows whose first row and column are ``i - k // 2``, at the positions
    ``crop:-crop`` of the last two axes (all inside the image for RMSE-SW's and RASE's crops)."""
    c = np.zeros(x.shape[:-2] + (x.shape[-2] + 1, x.shape[-1] + 1))
    c[..., 1:, 1:] = np.cumsum(np.cumsum(x, -2), -1)
    s = c[..., k:, k:] - c[..., :-k, k:] - c[..., k:, :-k] + c[..., :-k, :-k]
    lo = crop - k // 2
    return s[..., lo:x.shape[-2] - crop - k // 2, lo:x.shape[-1] - crop - k // 2] / (k * k)


def bef_np(x: np.ndarray, block: int = 8) -> float:
    """PSNR-B's blocking effect factor of one batch of ``(N, 1, H, W)`` images."""
    _, _, hh, ww = x.shape
    dh, dv = (x[..., :, :-1] - x[..., :, 1:]) ** 2, (x[..., :-1, :] - x[..., 1:, :]) ** 2
    on_h, on_v = np.arange(ww - 1) % block == block - 1, np.arange(hh - 1) % block == block - 1
    d_b = dh[..., on_h].sum() + dv[..., on_v, :].sum()
    d_bc = dh[..., ~on_h].sum() + dv[..., ~on_v, :].sum()
    n_hb, n_vb = hh * (ww / block) - 1, ww * (hh / block) - 1
    d_b, d_bc = d_b / (n_hb + n_vb), d_bc / ((hh * (ww - 1)) - n_hb + (ww * (hh - 1)) - n_vb)
    return (np.log2(block) / np.log2(min(hh, ww)) if d_b > d_bc else 0.0) * (d_b - d_bc)


def path_p1_data(sizes: dict = P_SIZES) -> dict:
    """P1 at the Kodak set's shape (seed 67): targets a gaussian-blurred (sigma 4) normal field per
    channel, rescaled to [0, 1] per image; preds ``clip(target + 0.05 N(0, 1))``; the luma
    ``0.299 R + 0.587 G + 0.114 B`` of each, for PSNR-B. float32 numpy arrays."""
    from scipy import ndimage

    rng = np.random.default_rng(67)
    n, (hh, ww) = sizes["p1_images"], sizes["p1_hw"]
    field = rng.standard_normal((n, 3, hh, ww), dtype=np.float32)
    field = np.stack(pmap(lambda f: ndimage.gaussian_filter(f, 4), field.reshape(-1, hh, ww), sizes["threads"])).reshape(field.shape)
    lo, hi = field.min(axis=(1, 2, 3), keepdims=True), field.max(axis=(1, 2, 3), keepdims=True)
    target = ((field - lo) / (hi - lo)).astype(np.float32)
    preds = np.clip(target + np.float32(0.05) * rng.standard_normal(target.shape, dtype=np.float32), 0, 1)
    luma = np.asarray([0.299, 0.587, 0.114], np.float32)[None, :, None, None]
    return {"preds": preds.astype(np.float32), "target": target, "luma_preds": (preds * luma).sum(1, keepdims=True),
            "luma_target": (target * luma).sum(1, keepdims=True)}


def path_p1_refs(data: dict, sizes: dict = P_SIZES) -> dict:
    """P1's float64 numpy values of every image of every batch: SSIM (``data_range=1.0``), MS-SSIM
    (each batch's range at each scale), PSNR with ``data_range=None`` (the zero-initialised extremes)
    and per image with ``data_range=1.0``, UQI, VIF, TV of the preds, RMSE-SW (window 8) and PSNR-B on
    the luma (one blocking factor per batch, summed, as the class sums them)."""
    th, b = sizes["threads"], sizes["p1_batch"]
    p, t = data["preds"].astype(np.float64), data["target"].astype(np.float64)
    n = len(p)
    parts = pmap(lambda i: ssim_parts_np(p[i], t[i], 1.0), range(n), th)
    ms = np.concatenate([ms_ssim_np(p[i:i + b], t[i:i + b], sizes["ms_betas"], th) for i in range(0, n, b)])
    sse = ((p - t) ** 2).reshape(n, -1).sum(1)
    dr = max(t.max(), 0.0) - min(t.min(), 0.0)
    lp, lt = data["luma_preds"].astype(np.float64), data["luma_target"].astype(np.float64)
    befs = [bef_np(lp[i:i + b]) for i in range(0, n, b)]
    l_mse = ((lp - lt) ** 2).sum() / lt.size + sum(befs)
    l_range = max(lt[i:i + b].max() - lt[i:i + b].min() for i in range(0, n, b))
    return {
        "ssim": float(np.mean([x[0] for x in parts])),
        "ms_ssim": float(ms.mean()),
        "psnr": float(10 * np.log10(dr ** 2 / (sse.sum() / t.size))),
        "psnr_dim": 10 * np.log10(1.0 / (sse / t[0].size)),
        "uqi": float(sum(x[2] for x in parts) / sum(x[3] for x in parts)),
        "vif": float(np.mean(pmap(lambda i: vif_np(p[i], t[i]), range(n), th))),
        "tv": float(np.abs(np.diff(p, axis=2)).sum() + np.abs(np.diff(p, axis=3)).sum()),
        "rmse_sw": float(np.mean(pmap(lambda i: np.sqrt(box_np((p[i] - t[i]) ** 2, 8, 4)).mean(), range(n), th))),
        "psnrb": float(10 * np.log10(l_range ** 2 / l_mse) if l_range > 2 else 10 * np.log10(1.0 / l_mse)),
    }


def check_p(name: str, got, want, kind: str, bound: float = 0.0) -> tuple:
    """``got`` against float64 ``want`` (a scalar or an array): ``window`` within ``P_WINDOW_TOL``
    absolute, ``psnr`` within ``P_PSNR_TOL`` relative, else within ``P_TOL`` relative or ``bound``.
    Returns (largest error, what it was allowed, the largest magnitude of ``want``)."""
    got = np.asarray(got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape}, float64 gives {want.shape}")
    err = np.abs(got - want)
    allowed = {"window": np.full(want.shape, P_WINDOW_TOL), "psnr": P_PSNR_TOL * np.abs(want)}.get(
        kind, np.maximum(P_TOL * np.abs(want), bound))
    if not np.all(np.isfinite(got)) or np.any(err > allowed):
        worst = int(np.argmax(err - allowed)) if err.ndim else 0
        raise AssertionError(f"{name} = {got.reshape(-1)[worst]!r}, float64 gives {want.reshape(-1)[worst]!r} (error"
                             f" {err.reshape(-1)[worst]:.3g}, allowed {np.asarray(allowed).reshape(-1)[worst]:.3g})")
    return float(err.max()), float(np.max(allowed)), float(np.max(np.abs(want)))


def _metric_steps(m, batches):
    """``update`` on each batch, synchronised and timed one by one, and one ``compute``: (value, the
    first update's ms (the graph tier's capture), the later updates' mean ms, the compute's ms, the
    peak of device memory above what was allocated before, in GiB)."""
    base = _peak_start()
    walls = []
    for batch in batches:
        sync()
        t0 = time.perf_counter()
        m.update(*batch)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    value = m.compute()
    sync()
    t_compute = (time.perf_counter() - t0) * 1e3
    return value, walls[0], float(np.mean(walls[1:])) if len(walls) > 1 else walls[0], t_compute, _peak_gib(base)


def free_device_memory() -> None:
    """Collect the cycles that earlier paths left (a metric and its graphs hold each other, and so their
    device tensors, until the cyclic collector runs) and hand the cached blocks back."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _peak_start() -> int:
    """Device memory allocated now, with the peak counter reset to it."""
    if not torch.cuda.is_available():
        return 0
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _peak_gib(base: int) -> float:
    """The peak of device memory since ``_peak_start``, above what was allocated then, in GiB."""
    return (torch.cuda.max_memory_allocated() - base) / 2**30 if torch.cuda.is_available() else 0.0


def _p_line(first_ms, update_ms, compute_ms, peak, err, allowed, scale) -> str:
    return (f"update {update_ms:.3f} ms (the first {first_ms:.3f}), compute {compute_ms:.3f} ms, peak +{peak:.3f} GiB,"
            f" error {err:.3g} on a float64 value of {scale:.6g} (allowed {allowed:.3g})")


def run_path_p1(device, tier_name: str, data: dict, refs: dict, sizes: dict = P_SIZES):
    """P1 on one tier: the image-quality classes over ``p1_images`` images in batches of ``p1_batch``,
    each ``update`` then one ``compute``, on the graph tier through ``fast_update`` (the scalar-state
    classes: one replay an update) and the list state of PSNR's ``dim`` eagerly; ``image_gradients``
    of each batch equal to numpy's float32 differences. Returns (values, {name: line}, errors)."""
    import torchmetrics_tpu_torch.image as ti
    from torchmetrics_tpu_torch.functional import image_gradients

    b = sizes["p1_batch"]
    dev = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    rgb = [(dev["preds"][i:i + b], dev["target"][i:i + b]) for i in range(0, len(data["preds"]), b)]
    luma = [(dev["luma_preds"][i:i + b], dev["luma_target"][i:i + b]) for i in range(0, len(data["preds"]), b)]
    cases = {  # name: (metric, batches, reference, kind)
        "SSIM": (ti.StructuralSimilarityIndexMeasure(data_range=1.0, device=device), rgb, "ssim", "window"),
        "MS-SSIM": (ti.MultiScaleStructuralSimilarityIndexMeasure(betas=tuple(sizes["ms_betas"]), device=device), rgb,
                    "ms_ssim", "window"),
        "PSNR": (ti.PeakSignalNoiseRatio(device=device), rgb, "psnr", "psnr"),
        "PSNR dim=(1,2,3)": (ti.PeakSignalNoiseRatio(data_range=1.0, dim=(1, 2, 3), reduction="none", device=device), rgb,
                             "psnr_dim", "psnr"),
        "UQI": (ti.UniversalImageQualityIndex(device=device), rgb, "uqi", "window"),
        "VIF": (ti.VisualInformationFidelity(device=device), rgb, "vif", "window"),
        "TV": (ti.TotalVariation(device=device), [(p,) for p, _ in rgb], "tv", "sum"),
        "RMSE-SW": (ti.RootMeanSquaredErrorUsingSlidingWindow(window_size=8, device=device), rgb, "rmse_sw", "sum"),
        "PSNR-B (luma)": (ti.PeakSignalNoiseRatioWithBlockedEffect(device=device), luma, "psnrb", "psnr"),
    }
    values, lines, errors = {}, {}, {}
    for name, (m, batches, key, kind) in cases.items():
        m.fast_update = True
        value, *walls, peak = _metric_steps(m, batches)
        errors[name] = check_p(f"path P1 {name} ({tier_name} tier)", value, refs[key], kind,
                               bound=gamma(len(batches), data["preds"][0].size * b) * abs(refs[key]))
        values[name] = _bits(value)
        lines[name] = _p_line(*walls, peak, *errors[name])
    sync()
    t0 = time.perf_counter()
    grads = [image_gradients(p) for p, _ in rgb]
    sync()
    wall = (time.perf_counter() - t0) * 1e3 / len(rgb)
    for (dy, dx), i in zip(grads, range(0, len(data["preds"]), b)):
        x = data["preds"][i:i + b]
        want_dy, want_dx = np.zeros_like(x), np.zeros_like(x)
        want_dy[..., :-1, :], want_dx[..., :, :-1] = x[..., 1:, :] - x[..., :-1, :], x[..., :, 1:] - x[..., :, :-1]
        if not (np.array_equal(dy.cpu().numpy(), want_dy) and np.array_equal(dx.cpu().numpy(), want_dx)):
            raise AssertionError(f"path P1 image_gradients ({tier_name} tier): not numpy's float32 differences")
    values["image_gradients"] = [hashlib.sha256(g.cpu().numpy().tobytes()).hexdigest() for pair in grads for g in pair]
    lines["image_gradients"] = f"{wall:.3f} ms a batch, equal to numpy's float32 differences"
    return values, lines, errors


def path_p2_data(sizes: dict = P_SIZES) -> dict:
    """P2 at CAVE's shape (seed 69): each scene one normal field shared by its bands plus a field of each
    band's own at 0.3 of its weight (neighbouring wavelengths of a scene are alike), both blurred with
    sigma 2, each band rescaled to [0.1, 1]; preds the target with 2% multiplicative noise. float32."""
    from scipy import ndimage

    rng = np.random.default_rng(69)
    shape = (sizes["p2_scenes"], sizes["p2_bands"], *sizes["p2_hw"])
    field = rng.standard_normal((shape[0], shape[1] + 1, *shape[2:]), dtype=np.float32)
    field = np.stack(pmap(lambda f: ndimage.gaussian_filter(f, 2), field.reshape(-1, *shape[2:]), sizes["threads"]))
    field = field.reshape(shape[0], shape[1] + 1, *shape[2:])
    field = field[:, :1] + np.float32(0.3) * field[:, 1:]
    lo, hi = field.min(axis=(2, 3), keepdims=True), field.max(axis=(2, 3), keepdims=True)
    target = (np.float32(0.1) + np.float32(0.9) * (field - lo) / (hi - lo)).astype(np.float32)
    preds = (target * (1 + np.float32(0.02) * rng.standard_normal(shape, dtype=np.float32))).astype(np.float32)
    return {"preds": preds, "target": target}


def _band_pair_q_np(x: np.ndarray, mu: np.ndarray, e: np.ndarray, k: int) -> np.ndarray:
    """For one scene's bands ``x`` (float64 ``(L, H, W)``) and their filtered means ``mu`` and squares
    ``e``: the UQI sum over the valid pixels of each band pair ``(k, r)``, ``r > k``."""
    r = slice(k + 1, None)
    mkr = mu[k] * mu[r]
    mu2 = mu * mu
    den = (e[k] - mu2[k]) + (e[r] - mu2[r])
    den *= mu2[k] + mu2[r]
    den += 2.0 ** -23
    uqi = valid_np(x[k] * x[r], gauss_np(*P_GAUSS))
    uqi -= mkr
    uqi *= mkr
    uqi *= 4
    uqi /= den
    return uqi.reshape(len(uqi), -1).sum(1)


def band_pair_q_np(x: np.ndarray, threads: int) -> np.ndarray:
    """Each band pair's UQI of float64 ``(N, L, H, W)`` bands, the mean over the scenes and valid pixels,
    in ``torch.triu_indices`` order (the pairs ``(k, r > k)`` of one band ``k`` are one job)."""
    n, bands = x.shape[:2]
    w = gauss_np(*P_GAUSS)
    sums = 0.0
    for s in range(n):
        mu = np.stack(pmap(lambda band: valid_np(band, w), x[s], threads))
        e = np.stack(pmap(lambda band: valid_np(band * band, w), x[s], threads))
        sums = sums + np.concatenate(pmap(lambda k: _band_pair_q_np(x[s], mu, e, k), range(bands - 1), threads))
    return sums / (n * (x.shape[2] - P_GAUSS[0] + 1) * (x.shape[3] - P_GAUSS[0] + 1))


def path_p2_refs(data: dict, sizes: dict = P_SIZES) -> dict:
    """P2's float64 numpy values: SAM over every pixel, ERGAS (``ratio=4``) per scene, RASE (window 8)
    over every scene, and D-lambda (``p=1``) from each band pair's UQI of the targets and of the preds
    (``q_target``, ``q_preds``), with SAM's derived float32 bound (``(2C + 6)·2^-24·|cot θ|`` a pixel)."""
    th = sizes["threads"]
    p, t = data["preds"].astype(np.float64), data["target"].astype(np.float64)
    n, bands = p.shape[:2]
    cos = np.clip((p * t).sum(1) / (np.linalg.norm(p, axis=1) * np.linalg.norm(t, axis=1)), -1, 1)
    theta = np.arccos(cos)
    rmse = np.sqrt(((p - t) ** 2).reshape(n, bands, -1).mean(2))
    ergas = 100 * 4 * np.sqrt(((rmse / t.reshape(n, bands, -1).mean(2)) ** 2).sum(1) / bands)
    rmse_map = sum(pmap(lambda i: np.sqrt(box_np((p[i] - t[i]) ** 2, 8, 4)), range(n), th)) / n
    target_mean = (sum(pmap(lambda i: box_np(t[i], 8, 4), range(n), th)) / 64 / n).mean(0)
    rase = (100 / target_mean * np.sqrt((rmse_map ** 2).mean(0))).mean()
    q_target, q_preds = band_pair_q_np(t, th), band_pair_q_np(p, th)
    return {"sam": float(theta.mean()), "sam_bound": float(((2 * bands + 6) * U32 * cos / np.sin(theta)).mean()),
            "ergas": float(ergas.mean()), "rase": float(rase), "q_target": q_target, "q_preds": q_preds,
            "d_lambda": float(np.abs(q_target - q_preds).mean())}


def check_d_lambda(name: str, m, value, refs: dict) -> tuple:
    """D-lambda is the mean of ``|Q_t - Q_p|`` over the band pairs, where the two UQIs of a pair are
    close (2% noise), so float32's rounding of each Q, about 1e-7, need not be small beside it. Each pair's two Qs are held to float64 within ``P_TOL`` relative (recomputed
    from the metric's states by the same function as its compute, which must give the metric's bits),
    and D within the bound those Qs imply: ``mean(|δQ_t| + |δQ_p|)``, their measured errors, plus the
    float32 rounding of the sum over pairs. Returns (error, allowed, float64 value) for D."""
    from torchmetrics_tpu_torch.functional.image.d_lambda import _pairwise_band_uqi

    state = m.metric_state
    preds, target = torch.cat(state["preds"]), torch.cat(state["target"])
    bands = preds.shape[1]
    pairs = torch.triu_indices(bands, bands, offset=1, device=preds.device)
    q_t, q_p = _pairwise_band_uqi(target, pairs), _pairwise_band_uqi(preds, pairs)
    again = (2 * torch.sum(torch.abs(q_t - q_p) ** 1) / (bands * (bands - 1))) ** 1.0
    if not torch.equal(again, value):
        raise AssertionError(f"{name}: the band pairs' UQIs give {float(again)!r}, the metric {float(value)!r}")
    err_t = check_p(f"{name} Q of the targets", q_t, refs["q_target"], "sum")[0]
    err_p = check_p(f"{name} Q of the preds", q_p, refs["q_preds"], "sum")[0]
    d_q = np.abs(q_t.cpu().numpy() - refs["q_target"]) + np.abs(q_p.cpu().numpy() - refs["q_preds"])
    bound = float(d_q.mean()) + (np.ceil(np.log2(len(d_q))) + K_SERIAL) * U32 * refs["d_lambda"]
    err, allowed, scale = check_p(name, value, refs["d_lambda"], "sum", bound=bound)
    return err, allowed, scale, max(err_t, err_p)


def run_path_p2(device, tier_name: str, data: dict, refs: dict, sizes: dict = P_SIZES):
    """P2 on one tier: SAM (sum states, a graph replay an update), ERGAS (``ratio=4``), RASE (window 8)
    and D-lambda (``p=1``, every band pair in blocks) over ``p2_scenes`` scenes in batches of
    ``p2_batch``; D-lambda checked through its band pairs' UQIs (``check_d_lambda``). Returns (values,
    {name: line}, errors)."""
    import torchmetrics_tpu_torch.image as ti

    b = sizes["p2_batch"]
    p, t = (torch.from_numpy(data[k]).to(device) for k in ("preds", "target"))
    batches = [(p[i:i + b], t[i:i + b]) for i in range(0, len(p), b)]
    cases = {
        "SAM": (ti.SpectralAngleMapper(device=device), "sam", refs["sam_bound"]),
        "ERGAS": (ti.ErrorRelativeGlobalDimensionlessSynthesis(ratio=4, device=device), "ergas", 0.0),
        "RASE": (ti.RelativeAverageSpectralError(window_size=8, device=device), "rase", 0.0),
        "D-lambda": (ti.SpectralDistortionIndex(p=1, device=device), "d_lambda", None),
    }
    values, lines, errors = {}, {}, {}
    for name, (m, key, bound) in cases.items():
        m.fast_update = True
        value, *walls, peak = _metric_steps(m, batches)
        label = f"path P2 {name} ({tier_name} tier)"
        if name == "D-lambda":
            *errors[name], q_err = check_d_lambda(label, m, value, refs)
        else:
            errors[name] = check_p(label, value, refs[key], "sum", bound=bound)
        values[name] = _bits(value)
        lines[name] = _p_line(*walls, peak, *errors[name])
        if name == "D-lambda":
            lines[name] += f"; each band pair's two UQIs within {q_err:.3g} of float64"
    return values, lines, errors


def path_p3_data(sizes: dict = P_SIZES) -> dict:
    """P3 at BERT-base's width (seed 71): ``p3_rows`` x ``p3_dim`` normal rows ``x`` and ``y``, the first
    ``p3_l1_rows`` of each for manhattan and minkowski, and ``p3_sample`` sorted sampled rows."""
    rng = np.random.default_rng(71)
    n, d = sizes["p3_rows"], sizes["p3_dim"]
    return {"x": rng.standard_normal((n, d), dtype=np.float32), "y": rng.standard_normal((n, d), dtype=np.float32),
            "rows": np.sort(rng.choice(sizes["p3_l1_rows"], sizes["p3_sample"], replace=False))}


def path_p3_refs(data: dict, sizes: dict = P_SIZES) -> dict:
    """P3's float64 numpy values on the sampled rows, each with its first-order float32 bound: products
    within ``(d + 4)·2^-24·Σ|x_i y_i|``, euclidean's Gram expansion within that bound's square root
    term ``(2·(d + 4)·2^-24·Σ|x y| + 4·2^-24·(‖x‖² + ‖y‖²)) / (2·dist)``, the L1 and L3 sums within
    ``(log2 d + 8)·2^-24`` relative; and euclidean's mean distance of every row (``reduction="mean"``)."""
    x, y, rows = (data[k].astype(np.float64) if k != "rows" else data[k] for k in ("x", "y", "rows"))
    d, m = x.shape[1], sizes["p3_l1_rows"]
    xs = x[rows]
    gam = (d + 4) * U32
    refs = {}
    for label, other in (("vs y", y), ("alone", x)):
        xn, on = xs / np.linalg.norm(xs, axis=1, keepdims=True), other / np.linalg.norm(other, axis=1, keepdims=True)
        lin, abs_lin = xs @ other.T, np.abs(xs) @ np.abs(other).T
        sq = np.maximum((xs ** 2).sum(1)[:, None] + (other ** 2).sum(1)[None, :] - 2 * lin, 0)
        dist = np.sqrt(sq)
        cos, lin_b = xn @ on.T, gam * abs_lin
        cos_b = gam * (np.abs(xn) @ np.abs(on).T)
        dist_b = (2 * lin_b + 4 * U32 * ((xs ** 2).sum(1)[:, None] + (other ** 2).sum(1)[None, :])) / (2 * np.maximum(dist, 1e-30))
        if label == "alone":  # the diagonal is zeroed
            for mat in (cos, lin, dist, cos_b, lin_b, dist_b):
                mat[np.arange(len(rows)), rows] = 0
        refs[f"cosine {label}"], refs[f"linear {label}"], refs[f"euclidean {label}"] = (cos, cos_b), (lin, lin_b), (dist, dist_b)
    means = np.empty(len(x))
    for i0 in range(0, len(x), 1024):  # every row's mean distance to y, from the float64 Gram expansion
        xb = x[i0:i0 + 1024]
        means[i0:i0 + 1024] = np.sqrt(np.maximum((xb ** 2).sum(1)[:, None] + (y ** 2).sum(1)[None, :] - 2 * xb @ y.T,
                                                 0)).mean(1)
    refs["euclidean mean"] = (means, 0.0)
    def l1_l3(row):
        diff = np.abs(y[:m] - row)
        return diff.sum(-1), (diff ** 3).sum(-1) ** (1 / 3)

    l1, l3 = (np.stack(v) for v in zip(*pmap(l1_l3, xs, sizes["threads"])))
    sum_gam = (np.ceil(np.log2(d)) + K_SERIAL) * U32
    refs["manhattan"], refs["minkowski p=3"] = (l1, sum_gam * l1), (l3, (sum_gam + 3 * U32) * l3)
    return refs


def run_path_p3(device, tier_name: str, data: dict, refs: dict, sizes: dict = P_SIZES):
    """P3 on one tier: cosine, euclidean and linear over ``x`` against ``y`` and alone (the diagonal
    zeroed), euclidean with ``reduction="mean"``, manhattan and minkowski (``exponent=3``) over the first
    ``p3_l1_rows`` rows of each; the sampled rows of each matrix (every row of the mean) held to
    float64. The entries are functional: the tier changes nothing, and the bits must say so."""
    from torchmetrics_tpu_torch.functional import pairwise as fp

    x, y = (torch.from_numpy(data[k]).to(device) for k in ("x", "y"))
    rows = torch.from_numpy(data["rows"]).to(device)
    m = sizes["p3_l1_rows"]
    calls = {
        "cosine vs y": lambda: fp.pairwise_cosine_similarity(x, y),
        "cosine alone": lambda: fp.pairwise_cosine_similarity(x),
        "euclidean vs y": lambda: fp.pairwise_euclidean_distance(x, y),
        "euclidean alone": lambda: fp.pairwise_euclidean_distance(x),
        "linear vs y": lambda: fp.pairwise_linear_similarity(x, y),
        "linear alone": lambda: fp.pairwise_linear_similarity(x),
        "euclidean mean": lambda: fp.pairwise_euclidean_distance(x, y, reduction="mean"),
        "manhattan": lambda: fp.pairwise_manhattan_distance(x[:m], y[:m]),
        "minkowski p=3": lambda: fp.pairwise_minkowski_distance(x[:m], y[:m], exponent=3),
    }
    values, lines, errors = {}, {}, {}
    for name, call in calls.items():
        base = _peak_start()
        sync()
        t0 = time.perf_counter()
        out = call()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        peak = _peak_gib(base)
        got = out if name == "euclidean mean" else out.index_select(0, rows)
        want, bound = refs[name]
        errors[name] = check_p(f"path P3 {name} ({tier_name} tier)", got, want, "sum", bound=bound)
        values[name] = _bits(got)
        shape = "x".join(str(s) for s in out.shape)
        lines[name] = (f"{shape} in {wall:.3f} ms, peak +{peak:.3f} GiB, error {errors[name][0]:.3g} on float64 values"
                       f" up to {errors[name][2]:.6g} (allowed up to {errors[name][1]:.3g}), {'every row' if name == 'euclidean mean' else f'{len(rows)} sampled rows'}")
        del out
    return values, lines, errors


def run_path_p(device, card: str, sizes: dict = P_SIZES):
    """Path P: the data and the float64 numpy side first, then every kernel's count set to 0, P1-P3 on
    the graph tier and on the eager tier, bit-equal, then P1-P3 once more on the graph tier under a
    caller's TF32 flags (``allow_tf32`` for cuBLAS and cuDNN set True), which must give the graph
    tier's bits and read True afterwards. No part launches K1, K2 or K3. Returns the seconds P took."""
    from torchmetrics_tpu_torch.ops.bincount import LaunchCounter

    started_p = time.perf_counter()
    d1, d2, d3 = path_p1_data(sizes), path_p2_data(sizes), path_p3_data(sizes)
    t_data = time.perf_counter() - started_p
    r1, r2, r3 = path_p1_refs(d1, sizes), path_p2_refs(d2, sizes), path_p3_refs(d3, sizes)
    print(f"path P: data in {t_data:.1f} s, the float64 numpy side in {time.perf_counter() - started_p - t_data:.1f} s"
          f" ({sizes['threads']} host threads)")
    for counter in LaunchCounter.ALL:
        counter.launches = 0
    parts = {"P1": (run_path_p1, d1, r1), "P2": (run_path_p2, d2, r2), "P3": (run_path_p3, d3, r3)}
    res = {}
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    for run in ("graph", "eager", "graph, caller's TF32 flags"):
        tier_name = run.split(",")[0]
        saved = tuple(f.allow_tf32 for f in flags)
        if run.endswith("flags"):
            for f in flags:
                f.allow_tf32 = True
        try:
            with tier(tier_name):
                res[run] = {}
                for part, (fn, data, refs) in parts.items():
                    t_part = time.perf_counter()
                    res[run][part], lines, _ = fn(device, tier_name, data, refs, sizes)
                    for label, line in lines.items():
                        print(f"path {part} [{card}] {label}, {run}: {line}")
                    print(f"path {part} [{card}] {run}: {time.perf_counter() - t_part:.1f} s")
            if run.endswith("flags") and not all(f.allow_tf32 for f in flags):
                raise AssertionError("path P changed the caller's TF32 flags")
        finally:
            for f, value in zip(flags, saved):
                f.allow_tf32 = value
    for part in parts:
        same_on_both_tiers(f"path {part}", res["graph"][part], res["eager"][part])
        same_on_both_tiers(f"path {part} under the caller's TF32 flags", res["graph"][part],
                           res["graph, caller's TF32 flags"][part])
    launches = {k: c.launches for k, c in kernel_counters().items()}
    if any(launches.values()):
        raise AssertionError(f"path P launched a kernel: {launches}")
    seconds = time.perf_counter() - started_p
    print(f"path P [{card}]: both tiers and the TF32 run bit-equal, kernel launches {launches}; {seconds:.1f} s")
    return seconds


Q_TOL = 1e-5
#: path Q's full sizes; the tests pass smaller ones. Q1 FID-50k (StyleGAN's and ADM's protocol) at
#: InceptionV3's pool width, KID at the reference's defaults, IS at InceptionV3's ``logits_unbiased``
#: width, MiFID at Kaggle's *Generative Dog Images* scale; Q2 LPIPS and PPL at 3 x 256 x 256; Q3
#: WSJ0-2mix's test set (3,000 two-speaker mixtures at 8 kHz, cut to 4 s) and SRMR at 16 kHz
Q_SIZES = {"q1_rows": 50_000, "q1_dim": 2048, "q1_batch": 500, "q1_rank": 64, "q1_images": 64, "q1_image_batches": 4,
           "q1_hw": 299, "kid_subsets": 100, "kid_subset_size": 1000, "is_classes": 1008, "is_splits": 10,
           "mifid_real": 20_000, "mifid_fake": 10_000, "mifid_copies": 8_000, "sqrtm_dim": 256,
           "q2_hw": 256, "q2_batch": 16, "q2_batches": 8, "ppl_samples": 10_000, "ppl_batch": 64, "ppl_latent": 512,
           "q3_mixtures": 3000, "q3_samples": 32_000, "q3_batch": 100, "sdr_mixtures": 200, "sdr_filter": 512,
           "stft": (512, 128), "srmr_utterances": 64, "srmr_samples": 64_000, "srmr_batch": 8, "threads": 8}
#: 10 / ln 10: decibels per unit of a natural-log ratio
DB = 10 / np.log(10)


class StandInInception(torch.nn.Module):
    """A seeded stand-in for InceptionV3's pool features: uint8 ``(N, 3, H, W)`` images to ``(N, dim)``
    non-negative features (three strided convolutions with ReLUs, a 4 x 4 average pool of ``dim / 16``
    channels: 128 at InceptionV3's 2048). Built in-process: no weights are downloaded."""

    def __init__(self, dim: int = 2048) -> None:
        super().__init__()
        gen = torch.Generator().manual_seed(73)
        nn = torch.nn
        self.net = nn.Sequential(nn.Conv2d(3, 32, 3, stride=2), nn.ReLU(), nn.Conv2d(32, 64, 3, stride=2), nn.ReLU(),
                                 nn.Conv2d(64, dim // 16, 3, stride=2), nn.ReLU(), nn.AdaptiveAvgPool2d(4), nn.Flatten())
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * (2.0 / max(1, p[0].numel())) ** 0.5)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.net(x.float() / 255.0)


class StandInAlexDistance(torch.nn.Module):
    """A seeded AlexNet-shaped LPIPS distance: AlexNet's five convolutions (64, 192, 384, 256, 256
    channels), each layer's features unit-normalised over channels, their squared difference weighted
    by non-negative 1 x 1 weights and averaged over space, summed over the layers: ``(img1, img2) ->
    (N,)`` on images in [-1, 1]."""

    def __init__(self) -> None:
        super().__init__()
        gen = torch.Generator().manual_seed(75)
        nn = torch.nn
        widths = (64, 192, 384, 256, 256)
        self.convs = nn.ModuleList([nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.Conv2d(64, 192, 5, padding=2),
                                    nn.Conv2d(192, 384, 3, padding=1), nn.Conv2d(384, 256, 3, padding=1),
                                    nn.Conv2d(256, 256, 3, padding=1)])
        self.lins = nn.ModuleList([nn.Conv2d(c, 1, 1, bias=False) for c in widths])
        with torch.no_grad():
            for p in self.convs.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * (2.0 / max(1, p[0].numel())) ** 0.5)
            for lin in self.lins:
                lin.weight.copy_(torch.rand(lin.weight.shape, generator=gen) / lin.weight.shape[1])
        self.eval()

    def _features(self, x):
        out = []
        for i, conv in enumerate(self.convs):
            x = torch.relu(conv(x))
            out.append(x)
            if i < 2:
                x = torch.nn.functional.max_pool2d(x, 3, 2)
        return out

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            total = 0.0
            for fa, fb, lin in zip(self._features(a), self._features(b), self.lins):
                fa = fa / (torch.linalg.vector_norm(fa, dim=1, keepdim=True) + 1e-10)
                fb = fb / (torch.linalg.vector_norm(fb, dim=1, keepdim=True) + 1e-10)
                total = total + lin((fa - fb) ** 2).mean(dim=(1, 2, 3))
            return total


class StandInGenerator(torch.nn.Module):
    """A seeded generator from 512-d latents to ``3 x hw x hw`` images in [0, 255] (a linear map to 256 x 4 x 4,
    transposed convolutions doubling the side to ``hw``, a sigmoid); ``sample(n)`` draws normal latents
    from its own seeded stream on its device."""

    def __init__(self, latent: int = 512, hw: int = 256, seed: int = 77) -> None:
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        nn = torch.nn
        layers, width, side = [], 256, 4
        while side < hw:
            out = max(8, width // 2)
            layers += [nn.ConvTranspose2d(width, out, 4, stride=2, padding=1), nn.ReLU()]
            width, side = out, side * 2
        self.fc = nn.Linear(latent, 256 * 16)
        self.up = nn.Sequential(*layers)
        self.out = nn.Conv2d(width, 3, 3, padding=1)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * (1.0 / max(1, p[0].numel())) ** 0.5)
        self.latent, self.seed = latent, seed
        self.stream = None
        self.eval()

    def sample(self, n: int) -> torch.Tensor:
        device = self.fc.weight.device
        if self.stream is None:
            self.stream = torch.Generator(device).manual_seed(self.seed)
        return torch.randn((n, self.latent), generator=self.stream, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            x = torch.relu(self.fc(z)).reshape(-1, 256, 4, 4)
            return 255 * torch.sigmoid(self.out(self.up(x)))


@contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the stand-in networks (the caller's choice, which the metrics
    leave alone), so that two runs of a network give the same bits; the flags are put back after."""
    backends = torch.backends.cudnn
    saved = backends.deterministic, backends.benchmark
    backends.deterministic, backends.benchmark = True, False
    try:
        yield
    finally:
        backends.deterministic, backends.benchmark = saved


def fid_np(mu1: np.ndarray, cov1: np.ndarray, mu2: np.ndarray, cov2: np.ndarray) -> float:
    """The Fréchet distance in float64 numpy by the two-eigh formula: ``tr Σ₁ + tr Σ₂ - 2 tr((S Σ₂ S)^½)
    + |Δμ|²`` with ``S = Σ₁^½``."""
    w1, v1 = np.linalg.eigh((cov1 + cov1.T) / 2)
    s = (v1 * np.sqrt(np.clip(w1, 0, None))) @ v1.T
    inner = s @ cov2 @ s
    w = np.linalg.eigvalsh((inner + inner.T) / 2)
    return float(((mu1 - mu2) ** 2).sum() + np.trace(cov1) + np.trace(cov2) - 2 * np.sqrt(np.clip(w, 0, None)).sum())


def path_q1_mixing(dim: int, rank: int, rng) -> tuple:
    """A covariance's factors: a per-feature scale and a rank-``rank`` shared component."""
    scale = rng.uniform(0.5, 1.5, dim).astype(np.float32)
    return scale, (rng.standard_normal((rank, dim), dtype=np.float32) / np.float32(np.sqrt(rank))).astype(np.float32)


def path_q1_features(rows: int, mixing: tuple, rng) -> np.ndarray:
    """Zero-mean float32 features of the covariance ``diag(scale²) + mixᵀ mix``."""
    scale, mix = mixing
    z = rng.standard_normal((rows, len(scale)), dtype=np.float32) * scale
    z += rng.standard_normal((rows, mix.shape[0]), dtype=np.float32) @ mix
    return z


def path_q1_data(sizes: dict = Q_SIZES) -> dict:
    """Q1's data (seed 73), float32 numpy: FID's and KID's real and generated features, which differ
    by a shifted mean and a covariance scaled by 1.15; IS's logits (about a hundred classes dominate);
    MiFID's non-negative features, ``mifid_copies`` of the generated rows near-copies of real rows
    (1% noise); and the extractor route's uint8 images."""
    rng = np.random.default_rng(73)
    n, d, r = sizes["q1_rows"], sizes["q1_dim"], sizes["q1_rank"]
    offset, mixing = rng.uniform(0.0, 1.0, d).astype(np.float32), path_q1_mixing(d, r, rng)
    real = path_q1_features(n, mixing, rng) + offset
    fake = np.float32(1.15) * path_q1_features(n, mixing, rng) + offset + np.float32(0.05)
    classes = sizes["is_classes"]
    logits = (rng.standard_normal((n, classes), dtype=np.float32) * np.float32(3.0)
              + np.float32(2.0) * (np.arange(classes) % 10 == 0).astype(np.float32))
    mr, mf, copies = sizes["mifid_real"], sizes["mifid_fake"], sizes["mifid_copies"]
    m_real = np.maximum(path_q1_features(mr, mixing, rng) + np.float32(3.0), 0).astype(np.float32)
    m_fake = np.maximum(path_q1_features(mf, mixing, rng) + np.float32(3.0), 0).astype(np.float32)
    pick = rng.choice(mr, copies, replace=False)
    m_fake[:copies] = m_real[pick] * (1 + np.float32(0.01) * rng.standard_normal((copies, d), dtype=np.float32))
    images = rng.integers(0, 256, (sizes["q1_image_batches"], sizes["q1_images"], 3, sizes["q1_hw"], sizes["q1_hw"]),
                          dtype=np.uint8)
    return {"real": real.astype(np.float32), "fake": fake.astype(np.float32), "logits": logits.astype(np.float32),
            "m_real": m_real, "m_fake": m_fake.astype(np.float32), "images": images}


def _kid_subset_np(fr: np.ndarray, ff: np.ndarray) -> tuple:
    """One subset's polynomial MMD² in float64 and its first-order float32 bound: each kernel entry
    ``(s + 1)³`` with ``s = x·y / d`` off by at most ``3 (|s| + 1)² (γ_d |x||y| / d + 2u (|s| + 1)) + 2u k``,
    the sums by ``γ_{m²}`` of their magnitude."""
    m, d = fr.shape
    g_d = (np.ceil(np.log2(d)) + K_SERIAL) * U32
    g_sum = (np.ceil(np.log2(m * m)) + K_SERIAL) * U32
    nr, nf = np.linalg.norm(fr, axis=1), np.linalg.norm(ff, axis=1)
    sums, errs = [], []
    for a, b, na, nb in ((fr, fr, nr, nr), (ff, ff, nf, nf), (fr, ff, nr, nf)):
        s = a @ b.T / d
        k = (s + 1.0) ** 3
        dk = 3 * (np.abs(s) + 1) ** 2 * (g_d * np.outer(na, nb) / d + 2 * U32 * (np.abs(s) + 1)) + 2 * U32 * np.abs(k)
        off = a is b
        sums.append(k.sum() - (np.trace(k) if off else 0.0))
        errs.append(dk.sum() + g_sum * np.abs(k).sum())
    value = (sums[0] + sums[1]) / (m * (m - 1)) - 2 * sums[2] / m**2
    return value, (errs[0] + errs[1]) / (m * (m - 1)) + 2 * errs[2] / m**2


def _is_np(logits: np.ndarray, splits: int, seed: int) -> tuple:
    """IS in float64 over ``RandomState(seed)``'s permutation and ``ceil(N / splits)``-row chunks: (mean,
    std with ddof 1, each chunk's score, each chunk's first-order float32 bound)."""
    from scipy.special import logsumexp

    n, classes = logits.shape
    x = logits[np.random.RandomState(seed).permutation(n)].astype(np.float64)
    log_p = x - logsumexp(x, axis=1, keepdims=True)
    p = np.exp(log_p)
    chunk = -(-n // splits)
    g = (np.ceil(np.log2(classes)) + np.ceil(np.log2(chunk)) + 2 * K_SERIAL) * U32
    scores, bounds = [], []
    for start in range(0, n, chunk):
        pp, lp, xx = p[start:start + chunk], log_p[start:start + chunk], x[start:start + chunk]
        log_mean = np.log(pp.mean(0, keepdims=True))
        score = np.exp((pp * (lp - log_mean)).sum(1).mean())
        spread = (pp * (4 * np.abs(xx).max(1, keepdims=True) + np.abs(lp - log_mean))).sum(1).mean()
        scores.append(score)
        bounds.append(score * g * spread)
    return float(np.mean(scores)), float(np.std(scores, ddof=1)), scores, bounds


def path_q1_refs(data: dict, sizes: dict = Q_SIZES) -> dict:
    """Q1's float64 numpy side: FID from ``np.cov`` by the two-eigh formula (and, at the leading
    ``sqrtm_dim`` features, the same formula against ``scipy.linalg.sqrtm``), with the first-order bound of
    the metric's float32 batch Gram matrices, ``4 √d γ_batch (‖X_r‖²_F + ‖X_f‖²_F) / (n - 1)``; KID over
    ``RandomState(73)``'s subsets (JAX's order), its mean's bound the subsets' mean bound and its std's
    their largest; IS (seed 73) with its chunks' bounds; MiFID, its distance's bound
    ``(ceil(log2 d) + 12) u`` relative to the distance."""
    from scipy.linalg import sqrtm

    th = sizes["threads"]
    real, fake = data["real"].astype(np.float64), data["fake"].astype(np.float64)
    n, d = real.shape
    mu_r, mu_f = real.mean(0), fake.mean(0)
    cov_r, cov_f = pmap(lambda x: np.cov(x, rowvar=False), (real, fake), 2)
    refs = {"fid": fid_np(mu_r, cov_r, mu_f, cov_f)}
    refs["fid_bound"] = 4 * np.sqrt(d) * gamma(1, sizes["q1_batch"]) * (
        np.square(real).sum() + np.square(fake).sum()) / (n - 1)
    k = min(sizes["sqrtm_dim"], d)
    sub = (mu_r[:k], cov_r[:k, :k], mu_f[:k], cov_f[:k, :k])
    via_sqrtm = float(((sub[0] - sub[2]) ** 2).sum() + np.trace(sub[1]) + np.trace(sub[3])
                      - 2 * np.trace(sqrtm(sub[1] @ sub[3]).real))
    refs["sqrtm_check"] = (fid_np(*sub), via_sqrtm)
    del real, fake, cov_r, cov_f
    m, subsets = sizes["kid_subset_size"], sizes["kid_subsets"]
    rng = np.random.RandomState(73)
    rows = [(rng.permutation(n)[:m], rng.permutation(n)[:m]) for _ in range(subsets)]
    kid = pmap(lambda rf: _kid_subset_np(data["real"][rf[0]].astype(np.float64), data["fake"][rf[1]].astype(np.float64)),
               rows, th)
    values, bounds = np.array([v for v, _ in kid]), np.array([b for _, b in kid])
    refs["kid"] = (float(values.mean()), float(values.std()))
    refs["kid_bound"] = (float(bounds.mean() + U32 * abs(values.mean())), float(bounds.max() + U32 * values.std()))
    is_mean, is_std, scores, is_bounds = _is_np(data["logits"], sizes["is_splits"], 73)
    refs["is"] = (is_mean, is_std)
    refs["is_bound"] = (float(np.mean(is_bounds)), float(2 * np.max(is_bounds)))
    mr, mf = data["m_real"].astype(np.float64), data["m_fake"].astype(np.float64)
    mifid_fid = fid_np(mr.mean(0), np.cov(mr, rowvar=False), mf.mean(0), np.cov(mf, rowvar=False))
    nr = mr[mr.sum(1) != 0] / np.linalg.norm(mr[mr.sum(1) != 0], axis=1, keepdims=True)
    nf = mf[mf.sum(1) != 0] / np.linalg.norm(mf[mf.sum(1) != 0], axis=1, keepdims=True)
    block = 2048
    minima = np.concatenate(pmap(lambda s: (1 - np.abs(nr[s:s + block] @ nf.T)).min(1), range(0, len(nr), block), th))
    distance = float(minima.mean())
    refs["mifid_distance"] = distance
    distance = distance if distance < 0.1 else 1.0
    refs["mifid"] = mifid_fid / (distance + 1e-14)
    refs["mifid_bound"] = refs["mifid"] * ((np.ceil(np.log2(d)) + 12) * U32 / distance + 2 * U32)
    return refs


def _q_line(update_ms, compute_ms, peak, err, allowed, scale, extra: str = "") -> str:
    first, rest = update_ms
    return (f"update {rest:.3f} ms (the first {first:.3f}), compute {compute_ms:.3f} ms, peak +{peak:.3f} GiB, error"
            f" {err:.3g} on a float64 value of {scale:.8g} (allowed {allowed:.3g}){extra}")


def _q_steps(m, batches, compute=True):
    """``update`` of each batch (each a tuple of positional arguments and a keyword dict), synchronised and
    timed one by one, and one timed ``compute``: (value, (the first update's ms, the later ones' mean ms),
    compute ms, peak GiB above the start, the graph tier's replays, captures and fallback reasons in that
    time). The graph tier's first update captures."""
    from torchmetrics_tpu_torch.ops import dispatch

    dispatch.STATS.reset()
    base = _peak_start()
    walls = []
    for args, kwargs in batches:
        sync()
        t0 = time.perf_counter()
        m.update(*args, **kwargs)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    value = m.compute() if compute else None
    sync()
    t_compute = (time.perf_counter() - t0) * 1e3
    stats = dispatch.STATS
    graph = {"replays": stats.replays, "captures": stats.captures,
             "fallbacks": sorted({f"{op} {reason}" for (_, op, reason) in stats.fallbacks})}
    updates = (walls[0], float(np.mean(walls[1:])) if len(walls) > 1 else walls[0])
    return value, updates, t_compute, _peak_gib(base), graph


def _tier_text(graph: dict) -> str:
    fallbacks = ", ".join(graph["fallbacks"]) or "none"
    return f"; {graph['captures']} captures, {graph['replays']} replays, eager fallbacks: {fallbacks}"


def run_path_q1(device, tier_name: str, data: dict, refs: dict, sizes: dict = Q_SIZES):
    """Q1 on one tier: FID-50k in raw-feature mode (``fast_update`` asked for: the class keeps JAX's
    ``jit_update = False``, so each update falls back, the reason printed), held to float64 numpy within
    its bound and to numpy's two-eigh formula on the metric's own states within 4u; the float32 formula's
    error beside it; the extractor route (a stand-in CNN as ``feature``, and with ``normalize=True`` on
    [0, 1] floats) bit-equal to raw-feature mode on the same features; KID at the reference's defaults,
    IS over 1,008 classes, MiFID with the penalty on. Returns (values, {name: line}, errors)."""
    import torchmetrics_tpu_torch.image as ti
    from torchmetrics_tpu_torch.image.generative import FrechetInceptionDistance, _compute_fid

    b, d = sizes["q1_batch"], sizes["q1_dim"]
    real, fake = (torch.from_numpy(data[k]).to(device) for k in ("real", "fake"))
    feeds = [((real[i:i + b],), {"real": True}) for i in range(0, len(real), b)]
    feeds += [((fake[i:i + b],), {"real": False}) for i in range(0, len(fake), b)]
    values, lines, errors = {}, {}, {}

    fid = ti.FrechetInceptionDistance(feature=None, num_features=d, device=device)
    fid.fast_update = True
    value, upd, comp, peak, graph = _q_steps(fid, feeds)
    state = fid.metric_state
    host = {k: v.double().cpu().numpy() for k, v in state.items()}

    def stats_np(prefix):
        n = host[f"{prefix}_features_num_samples"]
        mu = (host[f"{prefix}_features_sum"] + host[f"{prefix}_features_sum_comp"]) / n
        cov = (host[f"{prefix}_features_cov_sum"] + host[f"{prefix}_features_cov_sum_comp"] + host[f"{prefix}_mu_outer_sum"]
               + host[f"{prefix}_mu_outer_sum_comp"] - n * np.outer(mu, mu)) / (n - 1)
        return mu, cov

    same_states = fid_np(*stats_np("real"), *stats_np("fake"))
    check_rel(f"path Q1 FID from its states ({tier_name} tier)", value, same_states, 0.0, 4 * U32 * abs(same_states))
    err = check_rel(f"path Q1 FID-50k ({tier_name} tier)", value, refs["fid"], 0.0, refs["fid_bound"])
    f32 = _compute_fid(*FrechetInceptionDistance._stats(state, "real", torch.float32),
                       *FrechetInceptionDistance._stats(state, "fake", torch.float32))
    err32 = abs(float(f32) - refs["fid"])
    errors["FID-50k"] = (err, refs["fid_bound"], refs["fid"])
    values["FID-50k"] = _bits(value)
    lines["FID-50k"] = _q_line(upd, comp, peak, err, refs["fid_bound"], refs["fid"],
                               f"; from its states {abs(float(value) - same_states):.3g} off numpy's float64 formula;"
                               f" the float32 formula (JAX's) {float(f32):.8g}, error {err32:.3g}" + _tier_text(graph))
    del fid

    net = StandInInception(d).to(device)
    images = torch.from_numpy(data["images"]).to(device)
    half = len(images) // 2
    with deterministic_cudnn():
        routes = {}
        for label, feature_kw, imgs in (("uint8", {}, images), ("normalize=True", {"normalize": True}, images.float() / 255)):
            ext = ti.FrechetInceptionDistance(feature=net, device=device, **feature_kw)
            raw = ti.FrechetInceptionDistance(feature=None, num_features=d, device=device)
            t0 = time.perf_counter()
            for i, batch in enumerate(imgs):
                ext.update(batch, real=i < half)
            sync()
            wall = (time.perf_counter() - t0) * 1e3 / len(imgs)
            for i, batch in enumerate(imgs):
                as_uint8 = batch if batch.dtype == torch.uint8 else (batch * 255).to(torch.uint8)
                raw.update(net(as_uint8), real=i < half)
            got, want = ext.compute(), raw.compute()
            if _bits(got) != _bits(want):
                raise AssertionError(f"path Q1 extractor route {label} ({tier_name} tier): {float(got)!r}, raw-feature mode"
                                     f" {float(want)!r}")
            routes[label] = _bits(got)
            lines[f"FID extractor route, {label}"] = (f"{len(imgs)} batches of {imgs.shape[1]} x 3 x {imgs.shape[-1]} x"
                                                      f" {imgs.shape[-1]} through the stand-in CNN, {wall:.3f} ms an update;"
                                                      f" FID {float(got):.8g}, bit-equal to raw-feature mode")
        values["FID extractor"] = routes
    del net, images

    kid = ti.KernelInceptionDistance(feature=None, subsets=sizes["kid_subsets"], subset_size=sizes["kid_subset_size"],
                                     seed=73, device=device)
    kid.fast_update = True
    (k_mean, k_std), upd, comp, peak, graph = _q_steps(kid, feeds)
    e_mean = check_rel(f"path Q1 KID mean ({tier_name} tier)", k_mean, refs["kid"][0], 0.0, refs["kid_bound"][0])
    e_std = check_rel(f"path Q1 KID std ({tier_name} tier)", k_std, refs["kid"][1], 0.0, refs["kid_bound"][1])
    errors["KID"] = (e_mean, refs["kid_bound"][0], refs["kid"][0])
    values["KID"] = _bits((k_mean, k_std))
    lines["KID"] = (_q_line(upd, comp, peak, e_mean, refs["kid_bound"][0], refs["kid"][0])
                    + f"; std {float(k_std):.6g}, error {e_std:.3g} (allowed {refs['kid_bound'][1]:.3g})" + _tier_text(graph))
    del kid

    logits = torch.from_numpy(data["logits"]).to(device)
    inception = ti.InceptionScore(feature=None, splits=sizes["is_splits"], seed=73, device=device)
    (s_mean, s_std), upd, comp, peak, graph = _q_steps(inception, [((logits[i:i + b],), {}) for i in range(0, len(logits), b)])
    e_mean = check_rel(f"path Q1 IS mean ({tier_name} tier)", s_mean, refs["is"][0], 0.0, refs["is_bound"][0])
    e_std = check_rel(f"path Q1 IS std ({tier_name} tier)", s_std, refs["is"][1], 0.0, refs["is_bound"][1])
    errors["IS"] = (e_mean, refs["is_bound"][0], refs["is"][0])
    values["IS"] = _bits((s_mean, s_std))
    lines["IS"] = (_q_line(upd, comp, peak, e_mean, refs["is_bound"][0], refs["is"][0])
                   + f"; std {float(s_std):.6g}, error {e_std:.3g} (allowed {refs['is_bound'][1]:.3g})" + _tier_text(graph))
    del inception, logits

    m_real, m_fake = (torch.from_numpy(data[k]).to(device) for k in ("m_real", "m_fake"))
    mifid = ti.MemorizationInformedFrechetInceptionDistance(feature=None, device=device)
    feeds_m = [((m_real[i:i + b],), {"real": True}) for i in range(0, len(m_real), b)]
    feeds_m += [((m_fake[i:i + b],), {"real": False}) for i in range(0, len(m_fake), b)]
    value, upd, comp, peak, graph = _q_steps(mifid, feeds_m)
    if not refs["mifid_distance"] < 0.1:
        raise AssertionError(f"path Q1 MiFID: the distance {refs['mifid_distance']} leaves the penalty off")
    err = check_rel(f"path Q1 MiFID ({tier_name} tier)", value, refs["mifid"], 0.0, refs["mifid_bound"])
    errors["MiFID"] = (err, refs["mifid_bound"], refs["mifid"])
    values["MiFID"] = _bits(value)
    lines["MiFID"] = _q_line(upd, comp, peak, err, refs["mifid_bound"], refs["mifid"],
                             f"; cosine distance {refs['mifid_distance']:.6g} under eps 0.1" + _tier_text(graph))
    return values, lines, errors


def path_q2_data(sizes: dict = Q_SIZES) -> dict:
    """Q2's images (seed 75): reference images a blurred normal field rescaled to [0, 1], distorted
    ones with 3% gaussian noise, ``q2_batches`` batches of ``q2_batch``."""
    from scipy import ndimage

    rng = np.random.default_rng(75)
    n, hw = sizes["q2_batch"] * sizes["q2_batches"], sizes["q2_hw"]
    field = rng.standard_normal((n * 3, hw, hw), dtype=np.float32)
    field = np.stack(pmap(lambda f: ndimage.gaussian_filter(f, 3), field, sizes["threads"])).reshape(n, 3, hw, hw)
    lo, hi = field.min(axis=(1, 2, 3), keepdims=True), field.max(axis=(1, 2, 3), keepdims=True)
    img1 = ((field - lo) / (hi - lo)).astype(np.float32)
    img2 = np.clip(img1 + np.float32(0.03) * rng.standard_normal(img1.shape, dtype=np.float32), 0, 1).astype(np.float32)
    return {"img1": img1, "img2": img2}


def _ppl_np(dist: np.ndarray, lower: float, upper: float) -> tuple:
    """PPL's discards over the distances: the sorted float64 distances at JAX's float32 ``lower`` indices
    (``floor(q (n - 1))`` in float32), the kept mask, and the kept mean and std (ddof 1) in float64."""
    n = len(dist)
    ordered = np.sort(dist.astype(np.float64))
    lo = ordered[min(max(int(np.floor(np.float32(lower) * np.float32(n - 1))), 0), n - 1)]
    hi = ordered[min(max(int(np.floor(np.float32(upper) * np.float32(n - 1))), 0), n - 1)]
    keep = (dist >= lo) & (dist <= hi)
    kept = dist[keep].astype(np.float64)
    return keep, float(kept.mean()), float(kept.std(ddof=1))


def run_path_q2(device, tier_name: str, data: dict, refs: dict, sizes: dict = Q_SIZES):
    """Q2 on one tier: LPIPS (the AlexNet-shaped stand-in, ``normalize=True`` on [0, 1] images) over
    ``q2_batches`` batches, held to the float64 mean of the net's own per-pair distances; PPL
    (``ppl_samples`` latents of the stand-in generator in batches of ``ppl_batch``, ``epsilon=1e-4``,
    lerp and ``slerp_unit``, the net as ``sim_net``): its kept distances exactly the elements numpy's
    float64 discards keep of the same distances (the functional without discards gives them), mean and
    std within 1e-5 relative of float64. Returns (values, {name: line}, errors)."""
    import torchmetrics_tpu_torch.image as ti

    b = sizes["q2_batch"]
    img1, img2 = (torch.from_numpy(data[k]).to(device) for k in ("img1", "img2"))
    net = StandInAlexDistance().to(device)
    values, lines, errors = {}, {}, {}
    with deterministic_cudnn():
        pairs = [((img1[i:i + b], img2[i:i + b]), {}) for i in range(0, len(img1), b)]
        own = torch.cat([net(2 * x - 1, 2 * y - 1) for (x, y), _ in pairs]).double().cpu().numpy()
        lpips = ti.LearnedPerceptualImagePatchSimilarity(net_type=net, normalize=True, device=device)
        value, upd, comp, peak, graph = _q_steps(lpips, pairs)
        want = float(own.mean())
        bound = gamma(len(pairs), b) * float(np.abs(own).mean())
        err = check_rel(f"path Q2 LPIPS ({tier_name} tier)", value, want, Q_TOL, bound)
        errors["LPIPS"] = (err, max(Q_TOL * abs(want), bound), want)
        values["LPIPS"] = _bits(value)
        lines["LPIPS"] = _q_line(upd, comp, peak, err, errors["LPIPS"][1], want, _tier_text(graph))
        for method in ("lerp", "slerp_unit"):
            kwargs = dict(num_samples=sizes["ppl_samples"], batch_size=sizes["ppl_batch"], interpolation_method=method,
                          epsilon=1e-4, sim_net=net, seed=0)
            gen = StandInGenerator(sizes["ppl_latent"], sizes["q2_hw"]).to(device)
            base = _peak_start()
            ppl = ti.PerceptualPathLength(device=device, **kwargs)
            ppl.update(gen)
            sync()
            t0 = time.perf_counter()
            mean, std, kept = ppl.compute()
            sync()
            wall = (time.perf_counter() - t0) * 1e3
            peak = _peak_gib(base)
            *_, dist = ti.perceptual_path_length(StandInGenerator(sizes["ppl_latent"], sizes["q2_hw"]).to(device),
                                                 lower_discard=None, upper_discard=None, device=device, **kwargs)
            dist = dist.cpu().numpy()
            keep, want_mean, want_std = _ppl_np(dist, 0.01, 0.99)
            if not np.array_equal(kept.cpu().numpy(), dist[keep]):
                raise AssertionError(f"path Q2 PPL {method} ({tier_name} tier): kept {kept.numel()} distances, numpy's"
                                     f" discards keep {int(keep.sum())} others")
            g = gamma(1, len(kept))
            e_mean = check_rel(f"path Q2 PPL {method} mean ({tier_name} tier)", mean, want_mean, Q_TOL, g * want_mean)
            e_std = check_rel(f"path Q2 PPL {method} std ({tier_name} tier)", std, want_std, Q_TOL)
            errors[f"PPL {method}"] = (e_mean, max(Q_TOL * abs(want_mean), g * want_mean), want_mean)
            values[f"PPL {method}"] = _bits((mean, std, kept))
            lines[f"PPL {method}"] = (f"compute {wall:.3f} ms ({-(-sizes['ppl_samples'] // sizes['ppl_batch'])} generator"
                                      f" and sim_net batches), peak +{peak:.3f} GiB; kept {kept.numel()} of {len(dist)},"
                                      f" numpy's discards exactly; mean {float(mean):.8g} (error {e_mean:.3g}), std"
                                      f" {float(std):.8g} (error {e_std:.3g})")
    return values, lines, errors


def _ar_sources(rng, count: int, samples: int, fs: int) -> np.ndarray:
    """Speech-like float32 sources: AR(2) noise (poles at radius 0.8 and a random angle: a formant-like
    peak) under a syllable-rate envelope of 3-6 Hz, each at a random level."""
    from scipy.signal import lfilter

    out = np.empty((count, samples), np.float32)
    t = np.arange(samples) / fs
    for i in range(count):
        angle = rng.uniform(0.05, 0.6) * np.pi
        noise = lfilter([1.0], [1.0, -1.6 * np.cos(angle), 0.64], rng.standard_normal(samples))
        env = (0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 6) * t + rng.uniform(0, 2 * np.pi))) ** 2
        out[i] = (rng.uniform(0.3, 1.0) * noise * env / noise.std()).astype(np.float32)
    return out


def path_q3_data(sizes: dict = Q_SIZES) -> dict:
    """Q3's signals (seed 79): ``q3_mixtures`` two-speaker 8 kHz mixtures cut to ``q3_samples`` (4 s):
    the sources, and estimates that leak 20-30% of the other speaker plus 5% noise, their speaker order
    swapped in every other mixture; SRMR's ``srmr_utterances`` 16 kHz utterances."""
    rng = np.random.default_rng(79)
    m, t = sizes["q3_mixtures"], sizes["q3_samples"]
    target = _ar_sources(rng, 2 * m, t, 8000).reshape(m, 2, t)
    leak = rng.uniform(0.2, 0.3, (m, 2, 1)).astype(np.float32)
    preds = target + leak * target[:, ::-1] + np.float32(0.05) * rng.standard_normal(target.shape, dtype=np.float32)
    preds[::2] = preds[::2, ::-1]
    utterances = _ar_sources(rng, sizes["srmr_utterances"], sizes["srmr_samples"], 16000)
    return {"preds": preds.astype(np.float32), "target": target, "utterances": utterances}


def _si_sdr_np(p: np.ndarray, t: np.ndarray, axes=-1, zero_mean: bool = False, scale_invariant: bool = True):
    """SI-SDR (or SNR, or SA-SDR over two axes) in float64 with the metric's eps, and each value's
    first-order float32 bound in dB: ``10/ln10 (2 γ_T + 4u (1 + E_t / E_n))``."""
    eps = float(np.finfo(np.float32).eps)
    p, t = p.astype(np.float64), t.astype(np.float64)
    if zero_mean:
        p, t = p - p.mean(-1, keepdims=True), t - t.mean(-1, keepdims=True)
    if scale_invariant:
        t = ((p * t).sum(axes, keepdims=True) + eps) / ((t * t).sum(axes, keepdims=True) + eps) * t
    e_t, e_n = (t * t).sum(axes) + eps, ((t - p) ** 2).sum(axes) + eps
    length = np.prod([p.shape[a] for a in np.atleast_1d(axes)])
    g = (np.ceil(np.log2(length)) + K_SERIAL) * U32
    return 10 * np.log10(e_t / e_n), DB * (2 * g + 4 * U32 * (1 + e_t / e_n))


def _stft_np(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """``torch.stft(x, n_fft, hop, window=hann_window(n_fft), center=True, return_complex=True)`` in float64:
    reflect-padded by ``n_fft // 2``, periodic Hann, one-sided, ``(..., freq, frames)``."""
    pad = n_fft // 2
    x = np.pad(x.astype(np.float64), [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    frames = np.lib.stride_tricks.sliding_window_view(x, n_fft, axis=-1)[..., ::hop, :]
    return np.swapaxes(np.fft.rfft(frames * window, axis=-1), -1, -2)


def _sdr_np(p: np.ndarray, t: np.ndarray, filter_length: int):
    """SDR of one signal in float64 (``scipy.linalg.solve_toeplitz``), and its first-order float32 bound in
    dB from the Toeplitz system's condition number ``κ``: the correlations' errors ``‖δb‖, ‖δR‖ ≤ √L γ_fft``
    (unit-norm signals), the solve's backward error ``γ_L ‖R‖``, so ``‖δsol‖ ≤ κ (γ_L + √L γ_fft / λ_max)
    ‖sol‖ + ‖R⁻¹‖ √L γ_fft`` and ``δcoh ≤ √L γ_fft ‖sol‖ + ‖b‖ ‖δsol‖``, with ``γ_L = (√L + 8) u`` and
    ``γ_fft = (log2 n_fft + 8) u`` (errors that add as a random walk, not in the worst case)."""
    from scipy.linalg import solve_toeplitz

    p, t = p.astype(np.float64), t.astype(np.float64)
    t, p = t / max(np.linalg.norm(t), 1e-6), p / max(np.linalg.norm(p), 1e-6)
    n_fft = 2 ** int(np.ceil(np.log2(2 * len(t) - 1)))
    tf, pf = np.fft.rfft(t, n_fft), np.fft.rfft(p, n_fft)
    r0 = np.fft.irfft(np.abs(tf) ** 2, n_fft)[:filter_length]
    b = np.fft.irfft(np.conj(tf) * pf, n_fft)[:filter_length]
    sol = solve_toeplitz(r0, b)
    coh = float(b @ sol)
    eig = np.linalg.eigvalsh(r0[np.abs(np.arange(filter_length)[:, None] - np.arange(filter_length)[None, :])])
    kappa = eig[-1] / max(eig[0], 1e-300)
    root = np.sqrt(filter_length)
    g_fft, g_l = (np.log2(n_fft) + K_SERIAL) * U32, (root + K_SERIAL) * U32
    n_sol, n_b = np.linalg.norm(sol), np.linalg.norm(b)
    d_sol = kappa * (g_l + root * g_fft / eig[-1]) * n_sol + root * g_fft / max(eig[0], 1e-300)
    d_coh = root * g_fft * n_sol + n_b * d_sol
    return 10 * np.log10(coh / (1 - coh)), DB * d_coh * (1 / abs(coh) + 1 / abs(1 - coh)), kappa


def _aligned(preds):
    """The estimates in their sources' order: every other mixture's speakers swapped back (SDR is scored
    after the assignment, as WSJ0-2mix evaluations score it)."""
    out = preds.copy() if isinstance(preds, np.ndarray) else preds.clone()
    out[::2] = preds[::2, ::-1] if isinstance(preds, np.ndarray) else preds[::2].flip(1)
    return out


def path_q3_refs(data: dict, sizes: dict = Q_SIZES) -> dict:
    """Q3's float64 numpy side, batch by batch in host threads: PIT (SI-SNR, speaker-wise, the better of
    the two assignments), SI-SDR, SNR, SA-SDR, C-SI-SNR on numpy's STFT of the same signals, SDR over the
    first ``sdr_mixtures`` mixtures (the estimates in their sources' order) by ``solve_toeplitz``; each mean
    with its first-order float32 bound
    (the mean of the values' bounds and ``γ_b`` of the mean magnitude)."""
    preds, target = data["preds"], data["target"]
    b, n_fft, hop = sizes["q3_batch"], *sizes["stft"]

    def batch(start):
        p, t = preds[start:start + b], target[start:start + b]
        out = {"SI-SDR": _si_sdr_np(p, t), "SNR": _si_sdr_np(p, t, scale_invariant=False),
               "SA-SDR": _si_sdr_np(p, t, axes=(-2, -1))}
        direct, d_bound = _si_sdr_np(p, t, zero_mean=True)
        swapped, s_bound = _si_sdr_np(p[:, ::-1], t, zero_mean=True)
        pit_values = np.maximum(direct.mean(1), swapped.mean(1))
        out["PIT"] = (pit_values, np.maximum(d_bound.mean(1), s_bound.mean(1)))
        sp, st = _stft_np(p, n_fft, hop), _stft_np(t, n_fft, hop)
        flat = lambda z: np.stack([z.real, z.imag], -1).reshape(*z.shape[:-2], -1)  # noqa: E731
        c_values, c_bound = _si_sdr_np(flat(sp), flat(st))
        out["C-SI-SNR"] = (c_values, c_bound + DB * 4 * (np.log2(n_fft) + K_SERIAL) * U32)
        return out

    parts = pmap(batch, range(0, len(preds), b), sizes["threads"])
    refs = {}
    n_batches = len(parts)
    for name in parts[0]:
        vals = np.concatenate([np.ravel(part[name][0]) for part in parts])
        bounds = np.concatenate([np.ravel(part[name][1]) for part in parts])
        refs[name] = (float(vals.mean()), float(bounds.mean() + gamma(n_batches, vals.size // n_batches) * np.abs(vals).mean()))
    m = sizes["sdr_mixtures"]
    aligned = _aligned(preds[:m])
    sdr = pmap(lambda i: _sdr_np(aligned[i // 2, i % 2], target[i // 2, i % 2], sizes["sdr_filter"]), range(2 * m),
               sizes["threads"])
    vals = np.array([v for v, _, _ in sdr])
    refs["SDR"] = (float(vals.mean()), float(np.mean([bd for _, bd, _ in sdr]) + gamma(m // b, 2 * b) * np.abs(vals).mean()))
    refs["SDR kappa"] = float(np.max([k for _, _, k in sdr]))
    return refs


def run_path_q3(device, tier_name: str, data: dict, refs: dict, sizes: dict = Q_SIZES):
    """Q3 on one tier: PIT (SI-SNR, speaker-wise, ``max``), SI-SDR, SNR, SA-SDR and C-SI-SNR (on the card's
    512-point STFTs, hop 128, complex) over ``q3_mixtures`` mixtures in batches of ``q3_batch``, SDR
    (``filter_length=512``) over the first ``sdr_mixtures`` with the estimates in their sources' order, all on
    the graph tier through ``fast_update``
    (one capture, and a replay an update), each within its first-order float32 bound (or 1e-5 relative)
    of float64 numpy; SRMR over ``srmr_utterances`` 16 kHz utterances in batches of ``srmr_batch``, the
    host float64 pipeline, eager by design, its wall printed. Returns (values, {name: line}, errors)."""
    import torchmetrics_tpu_torch.audio as ta
    from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_noise_ratio

    b, n_fft, hop = sizes["q3_batch"], *sizes["stft"]
    preds, target = (torch.from_numpy(data[k]).to(device) for k in ("preds", "target"))
    feeds = [((preds[i:i + b], target[i:i + b]), {}) for i in range(0, len(preds), b)]
    window = torch.hann_window(n_fft, device=device)

    def stft(x):
        return torch.stft(x.reshape(-1, x.shape[-1]), n_fft, hop, window=window, return_complex=True).reshape(
            *x.shape[:-1], n_fft // 2 + 1, -1)

    spectra = [((stft(p), stft(t)), {}) for (p, t), _ in feeds]
    m = sizes["sdr_mixtures"]
    aligned = _aligned(preds[:m])
    cases = {
        "PIT": (ta.PermutationInvariantTraining(scale_invariant_signal_noise_ratio, device=device), feeds),
        "SI-SDR": (ta.ScaleInvariantSignalDistortionRatio(device=device), feeds),
        "SNR": (ta.SignalNoiseRatio(device=device), feeds),
        "SA-SDR": (ta.SourceAggregatedSignalDistortionRatio(device=device), feeds),
        "C-SI-SNR": (ta.ComplexScaleInvariantSignalNoiseRatio(device=device), spectra),
        "SDR": (ta.SignalDistortionRatio(filter_length=sizes["sdr_filter"], device=device),
                [((aligned[i:i + b], target[i:i + b]), {}) for i in range(0, m, b)]),
    }
    values, lines, errors = {}, {}, {}
    for name, (metric, batches) in cases.items():
        metric.fast_update = True
        value, upd, comp, peak, graph = _q_steps(metric, batches)
        want, bound = refs[name]
        err = check_rel(f"path Q3 {name} ({tier_name} tier)", value, want, Q_TOL, bound)
        if tier_name == "graph" and (graph["captures"] != 1 or graph["replays"] != len(batches) or graph["fallbacks"]):
            raise AssertionError(f"path Q3 {name}: expected one capture and a replay an update, got {graph}")
        errors[name] = (err, max(Q_TOL * abs(want), bound), want)
        values[name] = _bits(value)
        extra = f"; the Toeplitz systems' largest condition number {refs['SDR kappa']:.4g}" if name == "SDR" else ""
        lines[name] = _q_line(upd, comp, peak, err, errors[name][1], want, extra + _tier_text(graph))
    del spectra
    utterances = torch.from_numpy(data["utterances"]).to(device)
    srmr = ta.SpeechReverberationModulationEnergyRatio(16000, device=device)
    sb = sizes["srmr_batch"]
    value, upd, comp, peak, graph = _q_steps(srmr, [((utterances[i:i + sb],), {}) for i in range(0, len(utterances), sb)])
    if not (np.isfinite(float(value)) and float(value) > 0):
        raise AssertionError(f"path Q3 SRMR ({tier_name} tier): {float(value)!r}")
    values["SRMR"] = _bits(value)
    lines["SRMR"] = (f"{float(value):.8g} over {len(utterances)} utterances of {utterances.shape[1] / 16000:g} s at 16 kHz:"
                     f" {upd[1]:.1f} ms of host float64 an update of {sb} (the first {upd[0]:.1f}), compute {comp:.3f} ms"
                     + _tier_text(graph))
    return values, lines, errors


def run_path_q(device, card: str, sizes: dict = Q_SIZES):
    """Path Q: the data and the float64 numpy side first, then every kernel's count set to 0, Q1-Q3 on the
    graph tier and on the eager tier, bit-equal. No part launches K1, K2 or K3. Returns the seconds Q took."""
    from torchmetrics_tpu_torch.ops.bincount import LaunchCounter

    started_q = time.perf_counter()
    d1, d2, d3 = path_q1_data(sizes), path_q2_data(sizes), path_q3_data(sizes)
    t_data = time.perf_counter() - started_q
    r1 = path_q1_refs(d1, sizes)
    t_r1 = time.perf_counter() - started_q - t_data
    r3 = path_q3_refs(d3, sizes)
    fid_check = r1["sqrtm_check"]
    if abs(fid_check[0] - fid_check[1]) > 1e-8 * abs(fid_check[1]):
        raise AssertionError(f"path Q1: the two-eigh formula {fid_check[0]!r} and scipy's sqrtm {fid_check[1]!r} disagree")
    print(f"path Q: data in {t_data:.1f} s, the float64 numpy side in {t_r1:.1f} s (Q1) and"
          f" {time.perf_counter() - started_q - t_data - t_r1:.1f} s (Q3) ({sizes['threads']} host threads); at the"
          f" leading {sizes['sqrtm_dim']} features the two-eigh formula gives {fid_check[0]:.12g}, scipy's sqrtm"
          f" {fid_check[1]:.12g}")
    for counter in LaunchCounter.ALL:
        counter.launches = 0
    parts = {"Q1": (run_path_q1, d1, r1), "Q2": (run_path_q2, d2, None), "Q3": (run_path_q3, d3, r3)}
    res = {}
    for tier_name in ("graph", "eager"):
        with tier(tier_name):
            res[tier_name] = {}
            for part, (fn, data, refs) in parts.items():
                t_part = time.perf_counter()
                res[tier_name][part], lines, _ = fn(device, tier_name, data, refs, sizes)
                for label, line in lines.items():
                    print(f"path {part} [{card}] {label}, {tier_name} tier: {line}")
                print(f"path {part} [{card}] {tier_name} tier: {time.perf_counter() - t_part:.1f} s")
    for part in parts:
        same_on_both_tiers(f"path {part}", res["graph"][part], res["eager"][part])
    launches = {k: c.launches for k, c in kernel_counters().items()}
    if any(launches.values()):
        raise AssertionError(f"path Q launched a kernel: {launches}")
    seconds = time.perf_counter() - started_q
    print(f"path Q [{card}]: both tiers bit-equal, kernel launches {launches}; {seconds:.1f} s")
    return seconds


R_TOL = 1e-6
#: path R's full sizes; the tests pass smaller ones. R1 WMT14 En-De newstest2014 (3,003 segments, one reference
#: each), R2 LibriSpeech test-clean (2,620 utterances), R3 SQuAD v1.1 dev (10,570 questions) and CNN/DailyMail
#: test (11,490 summary pairs), R4 GPT-2's vocabulary and context over about WikiText-2 test's 287,000 GPT-2
#: tokens (280 windows of 1,024). ``eager_prefix`` items of R1 and R3 run on the eager tier, and TER and EED
#: (host Python, most of R's time) over the first ``r1_ter_eed`` segments on the graph tier; ``workers`` host
#: processes compute the oracles meanwhile (0: in this process)
R_SIZES = {"r1_segments": 3003, "r1_vocab": 32_000, "r1_mean_words": 25.0, "r1_max_words": 120, "r1_cjk": 300,
           "r2_utterances": 2620, "r2_vocab": 8_000, "r2_mean_words": 20.0, "r2_max_words": 100, "r2_edit": 0.05,
           "r3_questions": 10_570, "r3_pairs": 11_490, "r3_vocab": 20_000,
           "r4_vocab": 50_257, "r4_context": 1024, "r4_windows": 280, "r4_batch": 8, "r4_stride": 512,
           "batch": 64, "eager_prefix": 512, "r1_ter_eed": 1024, "workers": 5}
R1_METRICS = {"BLEU-4": ("BLEUScore", {}), "SacreBLEU 13a": ("SacreBLEUScore", {"tokenize": "13a"}),
              "chrF": ("CHRFScore", {"n_word_order": 0, "return_sentence_level_score": True}),
              "chrF++": ("CHRFScore", {"n_word_order": 2, "return_sentence_level_score": True}),
              "TER": ("TranslationEditRate", {}), "EED": ("ExtendedEditDistance", {})}
#: on the segments with CJK code points
R1_CJK_METRICS = {"SacreBLEU char": ("SacreBLEUScore", {"tokenize": "char"}),
                  "SacreBLEU zh": ("SacreBLEUScore", {"tokenize": "zh"})}
R2_RATES = {"WER": "WordErrorRate", "CER": "CharErrorRate", "MER": "MatchErrorRate", "WIL": "WordInfoLost",
            "WIP": "WordInfoPreserved"}


def _r_zipf(n: int, s: float = 1.1) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** s
    return p / p.sum()


def _r_vocab(rng, n: int, upper: bool, marks: bool) -> np.ndarray:
    """``n`` distinct word types of 2-10 ASCII letters, by rank; with ``marks``, 8% end in a punctuation
    mark and 7% are capitalised, as untokenised text holds them."""
    alphabet = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ'" if upper else "abcdefghijklmnopqrstuvwxyz"))
    words: dict = {}
    while len(words) < n:
        lens = rng.randint(2, 11, n)
        chars = alphabet[rng.randint(0, len(alphabet), int(lens.sum()))]
        for chunk in np.split(chars, np.cumsum(lens)[:-1]):
            words.setdefault("".join(chunk), None)
            if len(words) == n:
                break
    out = list(words)
    if marks:
        kind, mark = rng.rand(n), rng.randint(0, 8, n)
        signs = (",", ".", "?", "!", ";", ":", "'s", '"')
        out = [w + signs[m] if k < 0.08 else (w.capitalize() if k < 0.15 else w) for w, m, k in zip(out, mark, kind)]
    return np.array(out, dtype=object)


def _r_sentences(rng, v: int, p: np.ndarray, lens: np.ndarray) -> list:
    return np.split(rng.choice(v, int(lens.sum()), p=p), np.cumsum(lens)[:-1])


def _r_lengths(rng, count: int, mean: float, lo: int, hi: int, sigma: float = 0.5) -> np.ndarray:
    """Seeded lognormal lengths of mean ``mean``, rounded and clipped to ``[lo, hi]``."""
    return np.clip(np.round(rng.lognormal(np.log(mean) - sigma**2 / 2, sigma, count)), lo, hi).astype(np.int64)


def _r_hypotheses(rng, sentences: list, v: int, p: np.ndarray, rates: tuple, move: bool) -> list:
    """Each sentence of word ids with seeded substitutions, deletions and insertions (Zipf-drawn words)
    at ``rates``, and with ``move`` one phrase of 1-4 words moved to another place."""
    p_sub, p_del, p_ins = rates
    total = int(sum(len(s) for s in sentences))
    draw, extra = rng.rand(total), rng.choice(v, total, p=p)
    out, pos = [], 0
    for s in sentences:
        h: list = []
        for w, u, e in zip(s.tolist(), draw[pos:pos + len(s)], extra[pos:pos + len(s)].tolist()):
            if u < p_sub:
                h.append(e)
            elif u < p_sub + p_del:
                continue
            elif u < p_sub + p_del + p_ins:
                h += [w, e]
            else:
                h.append(w)
        pos += len(s)
        if move and len(h) > 4:
            k = rng.randint(1, 5)
            i = rng.randint(0, len(h) - k + 1)
            phrase, rest = h[i:i + k], h[:i] + h[i + k:]
            j = rng.randint(0, len(rest) + 1)
            h = rest[:j] + phrase + rest[j:]
        out.append(np.asarray(h, np.int64))
    return out


def path_r1_data(sizes: dict = R_SIZES) -> dict:
    """R1's stand-in for WMT14 En-De newstest2014 (seed 83): a Zipf vocabulary of ``r1_vocab`` ASCII word
    types with punctuation, reference lengths lognormal of mean ``r1_mean_words`` words clipped to 1-120,
    hypotheses by 8% substitutions, 5% deletions, 5% insertions and one phrase moved per segment; the
    first ``r1_cjk`` segments again with a third of the word types written as one or two CJK ideographs."""
    rng = np.random.RandomState(83)
    v = sizes["r1_vocab"]
    vocab, p = _r_vocab(rng, v, upper=False, marks=True), _r_zipf(v)
    ids = _r_sentences(rng, v, p, _r_lengths(rng, sizes["r1_segments"], sizes["r1_mean_words"], 1, sizes["r1_max_words"]))
    hyp_ids = _r_hypotheses(rng, ids, v, p, (0.08, 0.05, 0.05), move=True)
    cjk = np.array([chr(0x4E00 + 7919 * i % 20902) * (1 + i % 2) if i % 3 == 0 else w for i, w in enumerate(vocab)],
                   dtype=object)
    k = sizes["r1_cjk"]
    return {"refs": [" ".join(vocab[x]) for x in ids], "hyps": [" ".join(vocab[x]) for x in hyp_ids],
            "refs_cjk": [" ".join(cjk[x]) for x in ids[:k]], "hyps_cjk": [" ".join(cjk[x]) for x in hyp_ids[:k]]}


def path_r2_data(sizes: dict = R_SIZES) -> dict:
    """R2's stand-in for LibriSpeech test-clean (seed 85): upper-case transcripts over a Zipf vocabulary of
    ``r2_vocab`` word types, lengths lognormal of mean ``r2_mean_words`` clipped to 1-100, hypotheses with
    ``r2_edit`` word edits (a third each substituted, deleted, inserted); and both again with each word type
    written as one code point of plane 15's private use area, for the word-level edit distance."""
    rng = np.random.RandomState(85)
    v = sizes["r2_vocab"]
    vocab, p = _r_vocab(rng, v, upper=True, marks=False), _r_zipf(v)
    ids = _r_sentences(rng, v, p, _r_lengths(rng, sizes["r2_utterances"], sizes["r2_mean_words"], 1, sizes["r2_max_words"]))
    e = sizes["r2_edit"] / 3
    hyp_ids = _r_hypotheses(rng, ids, v, p, (e, e, e), move=False)
    symbol = np.array([chr(0xF0000 + i) for i in range(v)], dtype=object)
    return {"refs": [" ".join(vocab[x]) for x in ids], "hyps": [" ".join(vocab[x]) for x in hyp_ids],
            "refs_words": ["".join(symbol[x]) for x in ids], "hyps_words": ["".join(symbol[x]) for x in hyp_ids]}


def path_r3_data(sizes: dict = R_SIZES) -> dict:
    """R3 (seed 87): SQuAD v1.1 dev's ``r3_questions`` questions with 1-3 gold answers of 1-4 words, the
    predictions 55% the first answer with an article, a final stop or upper case added, 25% that answer
    less its last word plus another word, 20% unrelated words, one question in 50 unanswered; CNN/DailyMail
    test's ``r3_pairs`` summary pairs, the references 3-4 sentences of lognormal length (mean 14 words), the
    hypotheses the same sentences with 15% word edits, one sentence in three dropped and one in four moved."""
    rng = np.random.RandomState(87)
    v = sizes["r3_vocab"]
    vocab, p = _r_vocab(rng, v, upper=False, marks=True), _r_zipf(v)
    n = sizes["r3_questions"]
    n_answers = rng.randint(1, 4, n)
    answers = _r_sentences(rng, v, p, rng.randint(1, 5, int(n_answers.sum())))
    kind, style, extra = rng.rand(n), rng.randint(0, 3, n), rng.choice(v, (n, 4), p=p)
    preds, target, pos = [], [], 0
    for i in range(n):
        gold = [" ".join(vocab[a]) for a in answers[pos:pos + n_answers[i]]]
        first = answers[pos]
        pos += n_answers[i]
        target.append({"answers": {"answer_start": [0] * len(gold), "text": gold}, "id": f"q{i}"})
        if kind[i] < 0.55:
            text = ("the " + gold[0], gold[0] + ".", gold[0].upper())[style[i]]
        elif kind[i] < 0.8:
            text = " ".join(vocab[np.append(first[:-1], extra[i, 0])])
        else:
            text = " ".join(vocab[extra[i, :1 + style[i]]])
        if i % 50 != 49:
            preds.append({"prediction_text": text, "id": f"q{i}"})
    m = sizes["r3_pairs"]
    n_sent = rng.randint(3, 5, m)
    sents = _r_sentences(rng, v, p, _r_lengths(rng, int(n_sent.sum()), 14.0, 4, 40))
    edited = _r_hypotheses(rng, sents, v, p, (0.05, 0.05, 0.05), move=False)
    drop, moved = rng.rand(m) < 1 / 3, rng.rand(m) < 1 / 4
    summaries, references, pos = [], [], 0
    for i in range(m):
        ref = [" ".join(vocab[s]) for s in sents[pos:pos + n_sent[i]]]
        hyp = [" ".join(vocab[s]) for s in edited[pos:pos + n_sent[i]]]
        pos += n_sent[i]
        if drop[i]:
            hyp.pop(int(rng.randint(0, len(hyp))))
        if moved[i]:
            hyp.append(hyp.pop(0))
        references.append(". ".join(ref) + ".")
        summaries.append(". ".join(hyp) + ".")
    return {"squad_preds": preds, "squad_target": target, "rouge_preds": summaries, "rouge_target": references}


# ---- path R's oracles: plain Python, independent of the port's code, run in worker processes
_R13A = ((r"([\{-\~\[-\` -\&\(-\+\:-\@\/])", r" \1 "), (r"([^0-9])([\.,])", r"\1 \2 "), (r"([\.,])([^0-9])", r" \1 \2"),
         (r"([0-9])(-)", r"\1 \2 "))
_RCJK = ((0x3400, 0x4DB5), (0x4E00, 0x9FA5), (0x9FA6, 0x9FBB), (0xF900, 0xFA2D), (0xFA30, 0xFA6A), (0xFA70, 0xFAD9),
         (0x20000, 0x2A6D6), (0x2F800, 0x2FA1D), (0xFF00, 0xFFEF), (0x2E80, 0x2EFF), (0x3000, 0x303F), (0x31C0, 0x31EF),
         (0x2F00, 0x2FDF), (0x2FF0, 0x2FFF), (0x3100, 0x312F), (0x31A0, 0x31BF), (0xFE10, 0xFE1F), (0xFE30, 0xFE4F),
         (0x2600, 0x26FF), (0x2700, 0x27BF), (0x3200, 0x32FF), (0x3300, 0x33FF))


def tokenize_np(line: str, kind: str) -> list:
    """sacrebleu's ``none``, ``13a``, ``zh`` and ``char`` tokenizers, written from mteval-v13a's published
    rules and sacrebleu's CJK ranges."""
    import re

    if kind == "char":
        return [c for c in line if c != " "]
    if kind == "zh":
        line = "".join(f" {c} " if any(lo <= ord(c) <= hi for lo, hi in _RCJK) else c for c in line.strip())
    elif kind == "13a":
        line = line.replace("<skipped>", "").replace("-\n", "").replace("\n", " ")
        for a, b in (("&quot;", '"'), ("&amp;", "&"), ("&lt;", "<"), ("&gt;", ">")):
            line = line.replace(a, b)
        line = f" {line} "
    elif kind == "none":
        return line.split()
    for pattern, repl in _R13A:
        line = re.sub(pattern, repl, line)
    return line.split()


def bleu_np(hyps: list, refs: list, kind: str, n_gram: int = 4) -> float:
    """Corpus BLEU (one reference a segment, no smoothing, uniform weights) by ``Counter`` passes, float64."""
    from collections import Counter

    num, den, hyp_len, ref_len = np.zeros(n_gram), np.zeros(n_gram), 0, 0
    for h, r in zip(hyps, refs):
        h, r = tokenize_np(h, kind), tokenize_np(r, kind)
        hyp_len, ref_len = hyp_len + len(h), ref_len + len(r)
        for n in range(1, n_gram + 1):
            hc = Counter(tuple(h[i:i + n]) for i in range(len(h) - n + 1))
            rc = Counter(tuple(r[i:i + n]) for i in range(len(r) - n + 1))
            den[n - 1] += sum(hc.values())
            num[n - 1] += sum(min(c, rc[g]) for g, c in hc.items())
    if num.min() == 0:
        return 0.0
    penalty = 1.0 if hyp_len > ref_len else np.exp(1 - ref_len / hyp_len)
    return float(penalty * np.exp(np.mean(np.log(num / den))))


def chrf_np(hyps: list, refs: list, n_word: int, n_char: int = 6, beta: float = 2.0) -> tuple:
    """Corpus chrF (chrF++ with ``n_word`` 2) and the sentence scores, one reference a segment, by ``Counter``
    passes in float64: characters without spaces, words with a leading or trailing punctuation mark split
    off; a segment whose F is 0 adds no reference statistics, as the reference's best-reference rule has it."""
    from collections import Counter

    punct = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")

    def words(s):
        out = []
        for w in s.strip().split():
            if len(w) > 1 and w[-1] in punct:
                out += [w[:-1], w[-1]]
            elif len(w) > 1 and w[0] in punct:
                out += [w[0], w[1:]]
            else:
                out.append(w)
        return out

    def stats(h, r, order):
        out = []
        for n in range(1, order + 1):
            hc = Counter(tuple(h[i:i + n]) for i in range(len(h) - n + 1))
            rc = Counter(tuple(r[i:i + n]) for i in range(len(r) - n + 1))
            out.append((sum((hc & rc).values()), sum(hc.values()), sum(rc.values())))
        return out

    def f_of(rows):
        total = 0.0
        for match, hyp, ref in rows:
            prec = match / hyp if hyp > 0 else 0.0
            rec = match / ref if ref > 0 else 0.0
            total += (1 + beta**2) * prec * rec / max(beta**2 * prec + rec, 1e-16)
        return total / (n_char + n_word)

    corpus = np.zeros((n_char + n_word, 3))
    sentence = []
    for h, r in zip(hyps, refs):
        rows = stats(list(h.strip().replace(" ", "")), list(r.strip().replace(" ", "")), n_char)
        rows += stats(words(h), words(r), n_word)
        f = f_of(rows)
        sentence.append(f)
        rows = np.asarray(rows, np.float64)
        corpus[:, 1] += rows[:, 1]
        if f > 0:
            corpus[:, 0] += rows[:, 0]
            corpus[:, 2] += rows[:, 2]
    return f_of(corpus.tolist()), np.asarray(sentence)


def levenshtein_np(a, b, cost: int) -> int:
    """The plain Levenshtein DP over two sequences, in integers."""
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (0 if x == y else cost)))
        prev = cur
    return prev[-1]


def path_r_oracle(job: tuple):
    """One oracle of path R, run where the caller puts it (a worker process): ``(kind, arguments)`` to its
    value. The functionals run on the CPU, on the whole set."""
    kind, args = job
    if kind == "bleu":
        return bleu_np(*args)
    if kind == "chrf":
        return chrf_np(*args)
    if kind == "levenshtein":
        pairs, cost = args
        return np.asarray([levenshtein_np(a, b, cost) for a, b in pairs], np.int64)
    import torchmetrics_tpu_torch.functional as tf

    if kind == "ter":
        return float(tf.translation_edit_rate(args[0], [[r] for r in args[1]], device="cpu"))
    if kind == "eed":
        return float(tf.extended_edit_distance(args[0], [[r] for r in args[1]], device="cpu"))
    if kind == "rouge":
        return {k: float(v) for k, v in tf.rouge_score(*args, device="cpu").items()}
    if kind == "squad":
        return {k: float(v) for k, v in tf.squad(*args, device="cpu").items()}
    raise ValueError(kind)


def path_r_oracles(d1: dict, d2: dict, d3: dict, sizes: dict = R_SIZES):
    """Every host oracle of R1-R3 submitted to ``workers`` spawned processes (or, at 0, run here at once):
    ``(pool or None, {name: future or value})``. The caller shuts the pool down."""
    from concurrent.futures import Future, ProcessPoolExecutor
    import multiprocessing

    words = [(h.split(), r.split()) for h, r in zip(d2["hyps"], d2["refs"])]
    chars = [(list(h), list(r)) for h, r in zip(d2["hyps"], d2["refs"])]
    half = len(chars) // 2
    k = sizes["r1_ter_eed"]
    jobs = {"TER": ("ter", (d1["hyps"][:k], d1["refs"][:k])), "EED": ("eed", (d1["hyps"][:k], d1["refs"][:k])),
            "ROUGE": ("rouge", (d3["rouge_preds"], d3["rouge_target"])),
            "chars 1a": ("levenshtein", (chars[:half], 1)), "chars 1b": ("levenshtein", (chars[half:], 1)),
            "chars 2a": ("levenshtein", (chars[:half], 2)), "chars 2b": ("levenshtein", (chars[half:], 2)),
            "words 1": ("levenshtein", (words, 1)), "words 2": ("levenshtein", (words, 2)),
            "chrF": ("chrf", (d1["hyps"], d1["refs"], 0)), "chrF++": ("chrf", (d1["hyps"], d1["refs"], 2)),
            "BLEU-4": ("bleu", (d1["hyps"], d1["refs"], "none")),
            "SacreBLEU 13a": ("bleu", (d1["hyps"], d1["refs"], "13a")),
            "SacreBLEU char": ("bleu", (d1["hyps_cjk"], d1["refs_cjk"], "char")),
            "SacreBLEU zh": ("bleu", (d1["hyps_cjk"], d1["refs_cjk"], "zh")),
            "SQuAD": ("squad", (d3["squad_preds"], d3["squad_target"]))}
    if not sizes["workers"]:
        done = {}
        for name, job in jobs.items():
            done[name] = Future()
            done[name].set_result(path_r_oracle(job))
        return None, done
    pool = ProcessPoolExecutor(sizes["workers"], mp_context=multiprocessing.get_context("spawn"))
    return pool, {name: pool.submit(path_r_oracle, job) for name, job in jobs.items()}


# ---- path R's runs
def _r_steps(m, batches, prefix: int = 0):
    """``update`` of each batch (a tuple of arguments, or a callable that makes one when its turn comes),
    synchronised and timed one by one, and one timed ``compute``; with ``prefix``, the value after that many
    updates too. Returns (value, (the first update's ms, the later ones' mean ms), compute ms, prefix value,
    peak GiB above the start, the graph tier's captures, replays and fallback reasons in that time)."""
    from torchmetrics_tpu_torch.ops import dispatch

    dispatch.STATS.reset()
    base = _peak_start()
    walls, prefix_value = [], None
    for i, batch in enumerate(batches):
        args = batch() if callable(batch) else batch
        sync()
        t0 = time.perf_counter()
        m.update(*args)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
        if prefix and i + 1 == prefix:
            prefix_value = _bits(m.compute())
    t0 = time.perf_counter()
    value = m.compute()
    sync()
    t_compute = (time.perf_counter() - t0) * 1e3
    stats = dispatch.STATS
    graph = {"replays": stats.replays, "captures": stats.captures,
             "fallbacks": sorted({f"{op} {reason}" for (_, op, reason) in stats.fallbacks})}
    updates = (walls[0], float(np.mean(walls[1:])) if len(walls) > 1 else walls[0])
    return value, updates, t_compute, prefix_value, _peak_gib(base), graph


def _r_line(updates, compute_ms, peak, graph, extra: str = "") -> str:
    first, rest = updates
    return (f"update {rest:.3f} ms (the first {first:.3f}), compute {compute_ms:.3f} ms, peak +{peak:.4f} GiB"
            f"{extra}{_tier_text(graph)}")


def _r_batches(*columns, batch: int, limit: int = 0):
    n = len(columns[0]) if not limit else min(limit, len(columns[0]))
    return [tuple(c[i:i + batch] for c in columns) for i in range(0, n, batch)]


def _r_host_metric(tier_name: str, graph: dict, name: str) -> None:
    """A string metric keeps JAX's ``jit_update = False``: asked for ``fast_update``, it notes
    ``jit_update_off`` on either tier, and nothing else falls back."""
    if graph["fallbacks"] != ["update jit_update_off"]:
        raise AssertionError(f"path R {name} ({tier_name} tier): fallbacks {graph['fallbacks']}")


def run_path_r1(device, tier_name: str, data: dict, sizes: dict = R_SIZES):
    """R1 on one tier: BLEU-4, SacreBLEU 13a, chrF and chrF++ with sentence scores, TER and EED over the
    segments in updates of ``batch``, and SacreBLEU ``char`` and ``zh`` over the CJK segments; the eager tier
    over the first ``eager_prefix`` segments. Returns ({name: value}, {name: prefix bits}, {name: line})."""
    import torchmetrics_tpu_torch.text as tt

    limit = sizes["eager_prefix"] if tier_name == "eager" else 0
    prefix = sizes["eager_prefix"] // sizes["batch"]
    feeds = _r_batches(data["hyps"], [[r] for r in data["refs"]], batch=sizes["batch"], limit=limit)
    feeds_host = _r_batches(data["hyps"], [[r] for r in data["refs"]], batch=sizes["batch"],
                            limit=limit or sizes["r1_ter_eed"])
    feeds_cjk = _r_batches(data["hyps_cjk"], [[r] for r in data["refs_cjk"]], batch=sizes["batch"], limit=limit)
    values, prefixes, lines = {}, {}, {}
    for name, (cls, kwargs) in {**R1_METRICS, **R1_CJK_METRICS}.items():
        m = getattr(tt, cls)(**kwargs, device=device)
        m.fast_update = True
        batches = feeds_cjk if name in R1_CJK_METRICS else feeds_host if name in ("TER", "EED") else feeds
        value, upd, comp, prefix_value, peak, graph = _r_steps(m, batches, prefix if len(batches) > prefix else 0)
        _r_host_metric(tier_name, graph, name)
        values[name] = value
        prefixes[name] = _bits(value) if tier_name == "eager" or len(batches) <= prefix else prefix_value
        lines[name] = _r_line(upd, comp, peak, graph, f" over {sum(len(b[0]) for b in batches)} segments")
    return values, prefixes, lines


def run_path_r2(device, tier_name: str, data: dict, sizes: dict = R_SIZES):
    """R2 on one tier: WER, CER, MER, WIL and WIP, and ``EditDistance`` over characters and over words (each
    word type one code point) with ``substitution_cost`` 1 and 2 and ``reduction`` ``mean`` and ``none``,
    over every utterance in updates of ``batch``; then one CER update over the widest batch profiled: the
    row scan's device operations and device time. Returns ({name: value}, {name: line}, scan line)."""
    import torchmetrics_tpu_torch.functional as tf
    import torchmetrics_tpu_torch.text as tt

    b = sizes["batch"]
    feeds, feeds_words = (_r_batches(data["hyps"], data["refs"], batch=b),
                          _r_batches(data["hyps_words"], data["refs_words"], batch=b))
    cases = {name: (getattr(tt, cls)(device=device), feeds) for name, cls in R2_RATES.items()}
    for level, batches in (("chars", feeds), ("words", feeds_words)):
        for cost in (1, 2):
            for reduction in ("mean", "none"):
                cases[f"EditDistance {level} cost {cost} {reduction}"] = (
                    tt.EditDistance(substitution_cost=cost, reduction=reduction, device=device), batches)
    values, lines = {}, {}
    for name, (m, batches) in cases.items():
        m.fast_update = True
        value, upd, comp, _, peak, graph = _r_steps(m, batches)
        _r_host_metric(tier_name, graph, name)
        if tier_name == "graph" and graph["replays"] != len(batches):
            raise AssertionError(f"path R2 {name}: {graph['replays']} row-scan replays for {len(batches)} updates")
        values[name] = value
        lines[name] = _r_line(upd, comp, peak, graph)
    widest = max(feeds, key=lambda f: max(len(s) for s in f[0]))
    scan = f"one CER update over the widest batch, (B_pad, Lp, Lt) = {_edit_shape(widest)}: "
    if device.type == "cuda":
        tf.char_error_rate(*widest, device=device)  # the capture, outside the profile
        scan_us, scan_ops = device_profile(lambda: tf.char_error_rate(*widest, device=device), ("",), calls=3)
        scan += f"{scan_ops:.0f} device operations, {scan_us / 1e3:.3f} ms of device time"
    else:
        scan += "device time not measured off the card"
    return values, lines, scan


def _edit_shape(batch) -> tuple:
    from torchmetrics_tpu_torch.functional.text._edit import padded_ids

    pp, _, tt_, _ = padded_ids([list(s) for s in batch[0]], [list(s) for s in batch[1]])
    return pp.shape + tt_.shape[1:]


def run_path_r3(device, tier_name: str, data: dict, sizes: dict = R_SIZES):
    """R3 on one tier: ``SQuAD`` over the questions and ``ROUGEScore`` (``rouge1``, ``rouge2``, ``rougeL``,
    ``rougeLsum`` through the regex split) over the summary pairs, in updates of ``batch``; the eager tier
    over the first ``eager_prefix`` of each. Returns ({name: value}, {name: prefix bits}, {name: line})."""
    import torchmetrics_tpu_torch.text as tt

    limit = sizes["eager_prefix"] if tier_name == "eager" else 0
    prefix = sizes["eager_prefix"] // sizes["batch"]
    pred_of = {p["id"]: p for p in data["squad_preds"]}
    question_feeds = [([pred_of[t["id"]] for t in targets if t["id"] in pred_of], targets)
                      for (targets,) in _r_batches(data["squad_target"], batch=sizes["batch"], limit=limit)]
    cases = {"SQuAD": (tt.SQuAD(device=device), question_feeds),
             "ROUGE": (tt.ROUGEScore(device=device),
                       _r_batches(data["rouge_preds"], data["rouge_target"], batch=sizes["batch"], limit=limit))}
    values, prefixes, lines = {}, {}, {}
    for name, (m, batches) in cases.items():
        m.fast_update = True
        value, upd, comp, prefix_value, peak, graph = _r_steps(m, batches, prefix if len(batches) > prefix else 0)
        _r_host_metric(tier_name, graph, name)
        values[name] = value
        prefixes[name] = _bits(value) if tier_name == "eager" or len(batches) <= prefix else prefix_value
        lines[name] = _r_line(upd, comp, peak, graph)
    return values, prefixes, lines


def _r4_batch(device, sizes: dict, k: int, stride: bool):
    """Update ``k`` of R4: ``r4_batch`` windows of ``r4_context`` logits over ``r4_vocab`` drawn on the card
    from a ``torch.Generator`` seeded 89 + ``k`` (normal with standard deviation 2, plus a Zipf prior of
    ``-1.1 log rank``, as a language model's logits fall with a token's rank) and targets drawn from that
    Zipf law by inverse CDF (a float64 CDF made on the host and ``searchsorted``: ``torch.multinomial`` scans
    its CDF on the card in an order that varies from run to run, so its draws do); under the stride protocol
    every window but the first has its first ``r4_stride`` targets set to -100."""
    gen = torch.Generator(device=device).manual_seed(89 + k)
    b, n, v = sizes["r4_batch"], sizes["r4_context"], sizes["r4_vocab"]
    prior = -1.1 * torch.log(torch.arange(1, v + 1, device=device, dtype=torch.float32))
    logits = torch.randn(b, n, v, device=device, generator=gen) * 2.0 + prior
    cdf = torch.from_numpy(np.cumsum(_r_zipf(v))).to(device)
    u = torch.rand(b * n, device=device, generator=gen, dtype=torch.float64)
    target = torch.searchsorted(cdf, u * cdf[-1]).clamp_max(v - 1).reshape(b, n)
    if stride:
        first = torch.arange(k * b, (k + 1) * b, device=device) > 0
        target[:, :sizes["r4_stride"]] = torch.where(first[:, None], -100, target[:, :sizes["r4_stride"]])
    return logits, target


def r4_refs(device, sizes: dict, stride: bool) -> dict:
    """R4's float64 side for one run: each update's windows' negated log-likelihood summed in float64 on the
    card, the tokens counted, and the first-order bound of the metric's float32 sums; the first window's
    sum also in numpy float64 from a host copy of its logits."""
    total, count, sum_abs, term_err = 0.0, 0, 0.0, 0.0
    first = None
    n_updates = sizes["r4_windows"] // sizes["r4_batch"]
    v = sizes["r4_vocab"]
    for k in range(n_updates):
        logits, target = _r4_batch(device, sizes, k, stride)
        keep = target != -100
        x = logits.double()
        lse = torch.logsumexp(x, -1)
        xt = x.gather(-1, target.clamp_min(0)[..., None])[..., 0]
        nll = torch.where(keep, lse - xt, 0.0)
        total += float(nll.sum())
        count += int(keep.sum())
        sum_abs += float(nll.abs().sum())
        # one token's float32 error: the log-softmax's sum of V exponentials and its two subtractions
        term_err += float(torch.where(keep, gamma(0, v) + 2 * U32 * (lse.abs() + xt.abs()), 0.0).sum())
        if k == 0:
            row = logits[0].double().cpu().numpy()
            t0 = target[0].cpu().numpy()
            m = row.max(axis=1, keepdims=True)
            lse0 = (m[:, 0] + np.log(np.exp(row - m).sum(axis=1)))
            nll0 = lse0 - row[np.arange(len(t0)), np.maximum(t0, 0)]
            first = (float(nll0[t0 != -100].sum()), float(nll[0].sum()))
        del logits, x
    mean = total / count
    # the first-order bound of a sum over n_updates batches of B·L rows (PERF.md §2) and the terms' own
    # errors: it bounds log-perplexity's error, so perplexity's relative one
    bound = (term_err + gamma(n_updates, sizes["r4_batch"] * sizes["r4_context"]) * sum_abs) / count
    return {"value": float(np.exp(mean)), "bound": bound, "count": count, "first": first}


def run_path_r4(device, tier_name: str, refs: dict, sizes: dict = R_SIZES):
    """R4 on one tier: ``Perplexity`` over ``r4_windows`` windows at GPT-2's width in updates of ``r4_batch``
    (1.65 GB of float32 logits each), once with ``ignore_index=None`` and once under the stride-512 protocol
    with ``ignore_index=-100``, on the graph tier through ``fast_update`` (one capture, then a replay an
    update); each within its float32 bound of the float64 side. Then one update's time by CUDA events against
    its bytes bound, and on the graph tier the share of a copy of the batch, as into the static inputs. Returns
    ({run: value}, {run: line}, errors)."""
    import torchmetrics_tpu_torch.text as tt

    n_updates = sizes["r4_windows"] // sizes["r4_batch"]
    values, lines, errors = {}, {}, {}
    for run, stride in (("no ignore_index", False), ("stride 512, ignore_index=-100", True)):
        m = tt.Perplexity(ignore_index=-100 if stride else None, device=device)
        m.fast_update = True
        batches = [lambda k=k: _r4_batch(device, sizes, k, stride) for k in range(n_updates)]
        value, upd, comp, _, peak, graph = _r_steps(m, batches)
        want = refs[run]
        err = check_rel(f"path R4 Perplexity {run} ({tier_name} tier)", value, want["value"], 1e-5,
                        want["bound"] * want["value"])
        if tier_name == "graph" and (graph["captures"] != 1 or graph["replays"] != n_updates or graph["fallbacks"]):
            raise AssertionError(f"path R4 {run}: expected one capture and a replay an update, got {graph}")
        errors[run] = (err, max(1e-5 * want["value"], want["bound"] * want["value"]), want["value"])
        values[run] = _bits(value)
        lines[run] = _r_line(upd, comp, peak, graph, f", {float(value):.8g} over {want['count']:,} tokens, error"
                             f" {err:.3g} (allowed {errors[run][1]:.3g})")
    if device.type != "cuda":
        return values, lines, errors
    logits, target = _r4_batch(device, sizes, 1, False)
    probe = tt.Perplexity(device=device)
    probe.fast_update = True
    probe.update(logits, target)  # the capture on the graph tier
    update_ms = time_ms(lambda: probe.update(logits, target), 10)
    copy_ms = time_ms(lambda: torch.empty_like(logits).copy_(logits), 10) if tier_name == "graph" else 0.0
    n_bytes = logits.numel() * 4 + target.numel() * 8
    lines["one update"] = (f"{update_ms:.4f} ms by CUDA events against a bytes bound of {n_bytes / PEAK_BYTES_PER_S * 1e3:.4f}"
                           f" ms ({n_bytes / 1e9:.3f} GB at 3.35 TB/s); a copy of the batch into the graph's static"
                           f" inputs {copy_ms:.4f} ms, {copy_ms / update_ms:.3f} of it")
    return values, lines, errors


def check_r(name: str, values: dict, oracles: dict, d2: dict, sizes: dict) -> dict:
    """The graph tier's full values against the oracles: BLEU and chrF within ``R_TOL`` of the ``Counter``
    passes; R2's distances equal to the integer DP exactly and its rates within ``R_TOL`` of the DP's
    float64 rates; TER, EED, SQuAD and ROUGE against the functional over the whole set within the float32
    rounding of their batch sums. Returns {metric: (error, allowed)}."""
    errors = {}
    for metric in ("BLEU-4", "SacreBLEU 13a", "SacreBLEU char", "SacreBLEU zh"):
        errors[metric] = (check_rel(f"{name} {metric}", values[metric], oracles[metric], R_TOL), R_TOL)
    for metric in ("chrF", "chrF++"):
        score, sentences = values[metric]
        want, want_s = oracles[metric]
        errors[metric] = (check_rel(f"{name} {metric}", score, want, R_TOL), R_TOL)
        worst = float(np.max(np.abs(sentences.cpu().numpy().astype(np.float64) - want_s)))
        if worst > R_TOL:
            raise AssertionError(f"{name} {metric} sentence scores: {worst:.3g} off the Counter passes")
        errors[f"{metric} sentences"] = (worst, R_TOL)
    n_host = min(sizes["r1_ter_eed"], sizes["r1_segments"])
    n_updates = -(-n_host // sizes["batch"])
    for metric in ("TER", "EED"):
        want = oracles[metric]
        # TER's sums of whole numbers over the updates; EED's mean of float32 sentence scores
        allowed = (gamma(n_updates, 1) if metric == "TER" else gamma(1, n_host)) * abs(want)
        errors[metric] = (check_rel(f"{name} {metric}", values[metric], want, 0.0, allowed), allowed)
    # R2: the distances exactly, the rates from them
    dist = {(level, cost): np.concatenate([oracles[f"{level} {cost}a"], oracles[f"{level} {cost}b"]]) if level == "chars"
            else oracles[f"{level} {cost}"] for level in ("chars", "words") for cost in (1, 2)}
    for level in ("chars", "words"):
        for cost in (1, 2):
            got = values[f"EditDistance {level} cost {cost} none"].cpu().numpy()
            if not np.array_equal(got.astype(np.int64), dist[(level, cost)]):
                raise AssertionError(f"{name} EditDistance {level} cost {cost}: the distances differ from the integer DP"
                                     f" at {int(np.sum(got != dist[(level, cost)]))} pairs")
            mean = dist[(level, cost)].mean()
            errors[f"EditDistance {level} cost {cost} mean"] = (
                check_rel(f"{name} EditDistance {level} cost {cost} mean",
                          values[f"EditDistance {level} cost {cost} mean"], mean, R_TOL), R_TOL)
    t_words = np.array([len(r.split()) for r in d2["refs"]], np.float64)
    p_words = np.array([len(h.split()) for h in d2["hyps"]], np.float64)
    d_words = dist[("words", 1)].astype(np.float64)
    longest = np.maximum(t_words, p_words).sum()
    wer_errors = d_words.sum() - longest
    rates = {"WER": d_words.sum() / t_words.sum(),
             "CER": dist[("chars", 1)].sum() / sum(len(r) for r in d2["refs"]),
             "MER": d_words.sum() / longest,
             "WIL": 1 - (wer_errors / t_words.sum()) * (wer_errors / p_words.sum()),
             "WIP": (wer_errors / t_words.sum()) * (wer_errors / p_words.sum())}
    for metric, want in rates.items():
        errors[metric] = (check_rel(f"{name} {metric}", values[metric], want, R_TOL), R_TOL)
    # R3
    n_questions = -(-sizes["r3_questions"] // sizes["batch"])
    for key, want in oracles["SQuAD"].items():
        allowed = gamma(n_questions + 3, 1) * abs(want)
        errors[f"SQuAD {key}"] = (check_rel(f"{name} SQuAD {key}", values["SQuAD"][key], want, 0.0, allowed), allowed)
    for key, want in oracles["ROUGE"].items():
        allowed = gamma(2, sizes["r3_pairs"]) * abs(want)
        errors[f"ROUGE {key}"] = (check_rel(f"{name} ROUGE {key}", values["ROUGE"][key], want, 0.0, allowed), allowed)
    return errors


def run_path_r(device, card: str, sizes: dict = R_SIZES):
    """Path R: the data, the oracles started in worker processes, R4's float64 side, then every kernel's
    count set to 0 and R1-R4 on the graph tier and on the eager tier (R1 and R3 over their first
    ``eager_prefix`` items there, against the graph tier's value after as many); the tiers bit-equal, the
    graph tier's values held to the oracles. No part launches K1, K2 or K3. Returns the seconds R took."""
    from torchmetrics_tpu_torch.ops.bincount import LaunchCounter

    started = time.perf_counter()
    d1, d2, d3 = path_r1_data(sizes), path_r2_data(sizes), path_r3_data(sizes)
    t_data = time.perf_counter() - started
    pool, futures = path_r_oracles(d1, d2, d3, sizes)
    try:
        r4 = {"no ignore_index": r4_refs(device, sizes, False), "stride 512, ignore_index=-100": r4_refs(device, sizes, True)}
        for run, ref in r4.items():
            numpy_sum, card_sum = ref["first"]
            if abs(numpy_sum - card_sum) > 1e-9 * abs(numpy_sum):
                raise AssertionError(f"path R4 {run}: the first window's float64 sum {card_sum!r} on the card, {numpy_sum!r}"
                                     " in numpy")
        print(f"path R: data in {t_data:.1f} s (R1 {len(d1['refs'])} segments, {sum(len(r.split()) for r in d1['refs']):,}"
              f" reference words; R2 {len(d2['refs'])} utterances, {sum(len(r) for r in d2['refs']):,} characters; R3"
              f" {len(d3['squad_target'])} questions, {len(d3['rouge_target'])} summary pairs); R4's float64 side in"
              f" {time.perf_counter() - started - t_data:.1f} s, the first window's float64 sum equal in numpy to 1e-9")
        for counter in LaunchCounter.ALL:
            counter.launches = 0
        res, prefixes, full, errors = {}, {}, {}, {}
        for tier_name in ("graph", "eager"):
            with tier(tier_name):
                t_tier = time.perf_counter()
                v1, p1, l1 = run_path_r1(device, tier_name, d1, sizes)
                v2, l2, scan = run_path_r2(device, tier_name, d2, sizes)
                v3, p3, l3 = run_path_r3(device, tier_name, d3, sizes)
                v4, l4, e4 = run_path_r4(device, tier_name, r4, sizes)
                for part, lines in (("R1", l1), ("R2", l2), ("R3", l3), ("R4", l4)):
                    for label, line in lines.items():
                        print(f"path {part} [{card}] {label}, {tier_name} tier: {line}")
                print(f"path R2 [{card}] row scan, {tier_name} tier: {scan}")
                print(f"path R [{card}] {tier_name} tier: {time.perf_counter() - t_tier:.1f} s")
                prefixes[tier_name] = {"R1": p1, "R3": p3}
                res[tier_name] = {"R2": {k: _bits(v) for k, v in v2.items()}, "R4": v4}
                if tier_name == "graph":
                    full = {**v1, **v2, **v3}
                    errors["R4"] = e4
        for part in ("R1", "R3"):
            same_on_both_tiers(f"path {part} over the first {sizes['eager_prefix']} items", prefixes["graph"][part],
                               prefixes["eager"][part])
        for part in ("R2", "R4"):
            same_on_both_tiers(f"path {part}", res["graph"][part], res["eager"][part])
        t_wait = time.perf_counter()
        oracles = {name: future.result() for name, future in futures.items()}
        errors.update(check_r("path R", full, oracles, d2, sizes))
        print(f"path R [{card}]: the oracles' processes done {time.perf_counter() - t_wait:.1f} s after both tiers;"
              f" worst error against allowed: " + ", ".join(f"{k} {e:.3g}/{a:.3g}" for k, (e, a) in errors.items()
                                                             if k != "R4"))
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    launches = {k: c.launches for k, c in kernel_counters().items()}
    if any(launches.values()):
        raise AssertionError(f"path R launched a kernel: {launches}")
    seconds = time.perf_counter() - started
    print(f"path R [{card}]: reduced: R1 and R3 on the eager tier over their first {sizes['eager_prefix']} items"
          f" (the graph tier over all, its value after as many held bit-equal); TER and EED over the first"
          f" {sizes['r1_ter_eed']} segments on the graph tier (their host Python was most of R's time)")
    print(f"path R [{card}]: both tiers bit-equal, kernel launches {launches}; {seconds:.1f} s")
    return seconds


# ------------------------------------------------------------------ path S: the encoder-backed metrics
S_TOL = 1e-5
#: path S's full sizes; the tests pass smaller ones. S1 WMT16 En-De newstest2016 (2,999 segment pairs)
#: through a roberta-large-wide encoder, S2 its first 1,000 pairs through a bert-base-wide masked LM, S3 the
#: COCO Karpathy test split's 5,000 captioned images and S4 KonIQ-10k's 2,015 test images through ViT-L/14-wide
#: CLIP towers. ``s1_layers_pairs`` pairs take the all-layers variant
S_SIZES = {"s1_pairs": 2999, "s1_vocab": 32_000, "s1_mean_words": 25.0, "s1_max_words": 120, "batch": 64,
           "s1_layers_pairs": 64, "s1_chunk": 256, "s2_pairs": 1000, "s3_images": 5000, "s4_images": 2015,
           "roberta": {"vocab": 50_265, "layers": 24, "dim": 1024, "heads": 16, "ffn": 4096, "positions": 514},
           "num_layers": 17,
           "bert": {"vocab": 30_522, "layers": 12, "dim": 768, "heads": 12, "ffn": 3072, "positions": 512},
           "s2_max_length": 20, "temperature": 0.25,
           "vit": {"image": 224, "patch": 14, "layers": 24, "dim": 1024, "heads": 16, "ffn": 4096},
           "clip_text": {"vocab": 49_408, "context": 77, "layers": 12, "dim": 768, "heads": 12, "ffn": 3072},
           "clip_proj": 768, "seed": 89}
S_MEASURES = [("kl_divergence", None, None), ("alpha_divergence", 0.5, None), ("beta_divergence", None, 0.5),
              ("ab_divergence", 0.5, 1.5), ("renyi_divergence", 0.5, None), ("l1_distance", None, None),
              ("l2_distance", None, None), ("l_infinity_distance", None, None), ("fisher_rao_distance", None, None)]
S_IQA_PROMPTS = ("quality", "brightness", ("Good photo.", "Bad photo."))


class StandInTransformer(torch.nn.Module):
    """A pre-LN transformer encoder with seeded N(0, 0.02) weights, run in bfloat16 (the caller's model;
    the metrics only read what it returns). ``forward(ids or embeddings, pad mask)`` returns the hidden
    states after the embeddings and after each layer, in float32."""

    def __init__(self, cfg: dict, device, gen: torch.Generator, vocab: bool = True, causal: bool = False) -> None:
        super().__init__()
        d, f = cfg["dim"], cfg["ffn"]

        def w(*shape):
            return torch.nn.Parameter(torch.randn(*shape, device=device, generator=gen).mul_(0.02).to(torch.bfloat16),
                                      requires_grad=False)

        self.heads, self.causal = cfg["heads"], causal
        self.tok = w(cfg["vocab"], d) if vocab else None
        self.pos = w(cfg.get("positions", cfg.get("context", 1)), d)
        self.layers = torch.nn.ModuleList()
        for _ in range(cfg["layers"]):
            layer = torch.nn.Module()
            layer.qkv, layer.out, layer.fc1, layer.fc2 = w(3 * d, d), w(d, d), w(f, d), w(d, f)
            layer.ln1 = torch.nn.LayerNorm(d, device=device, dtype=torch.bfloat16)
            layer.ln2 = torch.nn.LayerNorm(d, device=device, dtype=torch.bfloat16)
            self.layers.append(layer)
        self.ln = torch.nn.LayerNorm(d, device=device, dtype=torch.bfloat16)

    @torch.no_grad()
    def forward(self, x, pad: torch.Tensor, depth: int = None):
        """``x`` int ids ``(N, L)`` or bfloat16 embeddings ``(N, L, d)``; ``pad`` bool ``(N, L)``, True where
        real. Returns ``depth + 1`` hidden states (all of them by default), float32."""
        h = self.tok[x] if x.dtype in (torch.int32, torch.int64) else x
        h = h + self.pos[: h.shape[1]]
        n, length, d = h.shape
        mask = pad[:, None, None, :]
        if self.causal:
            mask = mask & torch.ones(length, length, dtype=torch.bool, device=h.device).tril()
        states = [h.float()]
        for layer in self.layers[: depth if depth is not None else len(self.layers)]:
            q, k, v = torch.nn.functional.linear(layer.ln1(h), layer.qkv).view(n, length, 3, self.heads, -1).unbind(2)
            a = torch.nn.functional.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                                                 attn_mask=mask)
            h = h + torch.nn.functional.linear(a.transpose(1, 2).reshape(n, length, d), layer.out)
            h = h + torch.nn.functional.linear(torch.nn.functional.gelu(torch.nn.functional.linear(layer.ln2(h), layer.fc1)),
                                               layer.fc2)
            states.append(h.float())
        return states


def _s_hash(word: str, lo: int, hi: int) -> int:
    import zlib

    return lo + zlib.crc32(word.encode()) % (hi - lo)


def s1_tokenize(sentences: list, vocab: int, max_length: int = 512):
    """The stand-in word-hash tokenizer of S1 (roberta's ids: ``<s>`` 0, pad 1, ``</s>`` 2): one id a word,
    each sentence framed by ``<s>``/``</s>``, which the mask leaves out as special. Returns numpy ids and
    mask ``(N, L)``, L the longest framed sentence."""
    rows = [[0] + [_s_hash(w, 3, vocab) for w in s.split()][: max_length - 2] + [2] for s in sentences]
    width = max([len(r) for r in rows] + [2])
    ids = np.ones((len(rows), width), np.int64)
    mask = np.zeros((len(rows), width), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, 1:len(r) - 1] = 1
    return ids, mask


class StandInEncoders:
    """The stand-in models of path S on one card, built once from seed ``seed``: S1's roberta-large-wide
    encoder, S2's bert-base-wide masked LM with its head, S3's and S4's CLIP towers. Each callable records
    what it returned last (``recorded``), which the float64 oracles read."""

    def __init__(self, device, sizes: dict) -> None:
        self.device, self.sizes = device, sizes
        gen = torch.Generator(device=device).manual_seed(sizes["seed"])
        self.roberta = StandInTransformer(sizes["roberta"], device, gen)
        self.bert = StandInTransformer(sizes["bert"], device, gen)
        d = sizes["bert"]["dim"]
        self.mlm_dense = torch.randn(d, d, device=device, generator=gen).mul_(0.02).to(torch.bfloat16)
        self.mlm_ln = torch.nn.LayerNorm(d, device=device, dtype=torch.bfloat16)
        vit, text = sizes["vit"], sizes["clip_text"]
        self.vit = StandInTransformer(dict(vit, positions=(vit["image"] // vit["patch"]) ** 2 + 1), device, gen, vocab=False)
        self.patch = torch.randn(vit["dim"], 3, vit["patch"], vit["patch"], device=device, generator=gen).mul_(0.02).to(torch.bfloat16)
        self.cls = torch.randn(vit["dim"], device=device, generator=gen).mul_(0.02).to(torch.bfloat16)
        self.vit_proj = torch.randn(sizes["clip_proj"], vit["dim"], device=device, generator=gen).mul_(0.02).to(torch.bfloat16)
        self.text = StandInTransformer(text, device, gen, causal=True)
        self.text_proj = torch.randn(sizes["clip_proj"], text["dim"], device=device, generator=gen).mul_(0.02).to(torch.bfloat16)
        for module in (self.roberta, self.bert, self.mlm_ln, self.vit, self.text):
            module.requires_grad_(False)
        self.recorded = {}
        # one small pass through each model, so that the timed runs find their kernels chosen and loaded
        self.bert_score_encoder(False)(["a b"])
        self.masked_lm(["a b"])
        side = sizes["vit"]["image"]
        self.clip_encoders(False)[0](torch.zeros((1, 3, side, side), device=device))
        self.clip_encoders(True)[1](["a b"])
        self.recorded = {}

    # ---- S1
    def bert_score_encoder(self, layer_stacked: bool):
        """``encoder(sentences) -> (hidden (N, L, 1024) or all 25 states (N, 25, L, 1024), mask)``, in chunks
        of ``s1_chunk`` sentences padded to the longest of all."""
        sizes, vocab = self.sizes, self.sizes["roberta"]["vocab"]

        def encoder(sentences):
            ids, mask = s1_tokenize(sentences, vocab)
            ids_d = torch.from_numpy(ids).to(self.device)
            pad = ids_d != 1
            outs = []
            for lo in range(0, ids_d.shape[0], sizes["s1_chunk"]):
                states = self.roberta(ids_d[lo:lo + sizes["s1_chunk"]], pad[lo:lo + sizes["s1_chunk"]],
                                      None if layer_stacked else sizes["num_layers"])
                outs.append(torch.stack(states, 1) if layer_stacked else states[sizes["num_layers"]])
            emb = torch.cat(outs) if outs else torch.zeros((0, ids.shape[1], sizes["roberta"]["dim"]), device=self.device)
            self.recorded.setdefault("s1", []).append((emb, mask))
            return emb, torch.from_numpy(mask).to(self.device)

        encoder.layer_stacked = layer_stacked
        return encoder

    def s1_tokenize(self, sentences):
        return s1_tokenize(sentences, self.sizes["roberta"]["vocab"])

    # ---- S2
    def s2_tokenize(self, sentences):
        """bert's ids (``[CLS]`` 101, ``[SEP]`` 102, pad 0) at the fixed width ``s2_max_length``."""
        width, vocab = self.sizes["s2_max_length"], self.sizes["bert"]["vocab"]
        ids = np.zeros((len(sentences), width), np.int64)
        mask = np.zeros((len(sentences), width), np.int64)
        for i, s in enumerate(sentences):
            words = [_s_hash(w, min(1000, vocab // 2), vocab) for w in s.split()][: width - 2]
            ids[i, :len(words) + 2] = [101] + words + [102]
            mask[i, 1:len(words) + 1] = 1
        return ids, mask

    def masked_lm(self, sentences):
        """Each position's MLM distribution with that position replaced by ``[MASK]`` (103): L passes a
        batch, ``softmax(logits / temperature)`` in float32."""
        ids, mask = self.s2_tokenize(sentences)
        ids_d = torch.from_numpy(ids).to(self.device)
        pad = ids_d != 0
        probs = torch.empty(ids.shape + (self.sizes["bert"]["vocab"],), device=self.device)
        for pos in range(ids.shape[1]):
            masked = ids_d.clone()
            masked[:, pos] = 103
            h = self.bert(masked, pad)[-1][:, pos].to(torch.bfloat16)
            h = self.mlm_ln(torch.nn.functional.gelu(torch.nn.functional.linear(h, self.mlm_dense)))
            logits = torch.nn.functional.linear(h, self.bert.tok).float()
            probs[:, pos] = torch.softmax(logits / self.sizes["temperature"], dim=-1)
        mask_d = torch.from_numpy(mask).to(self.device)
        self.recorded.setdefault("s2", []).append((probs, mask))
        return probs, mask_d

    # ---- S3, S4
    def clip_encoders(self, rescale_uint8: bool):
        """``(image_encoder, text_encoder)``: ViT-L/14-wide over 224 x 224 images (a list of uint8 images, or a
        float batch already scaled), the class token projected to 768; a 77-token causal text tower, the
        end-of-text token projected to 768."""
        vit, text = self.sizes["vit"], self.sizes["clip_text"]
        mean = torch.tensor([0.4815, 0.4578, 0.4082], device=self.device)[:, None, None]
        std = torch.tensor([0.2686, 0.2613, 0.2758], device=self.device)[:, None, None]

        def image_encoder(images):
            x = torch.stack(list(images)) if isinstance(images, (list, tuple)) else images
            x = x.to(self.device, torch.float32)
            if rescale_uint8:
                x = x / 255.0
            x = ((x - mean) / std).to(torch.bfloat16)
            patches = torch.nn.functional.conv2d(x, self.patch, stride=vit["patch"]).flatten(2).transpose(1, 2)
            h = torch.cat([self.cls.expand(patches.shape[0], 1, -1), patches], 1)
            states = self.vit(h, torch.ones(h.shape[:2], dtype=torch.bool, device=self.device))
            feats = torch.nn.functional.linear(self.vit.ln(states[-1][:, 0].to(torch.bfloat16)), self.vit_proj).float()
            self.recorded.setdefault("image", []).append(feats)
            return feats

        def text_encoder(captions):
            ids = np.zeros((len(captions), text["context"]), np.int64)
            eot = np.zeros(len(captions), np.int64)
            for i, c in enumerate(captions):
                words = [_s_hash(w, 1, text["vocab"] - 2) for w in c.split()][: text["context"] - 2]
                ids[i, :len(words) + 2] = [text["vocab"] - 2] + words + [text["vocab"] - 1]
                eot[i] = len(words) + 1
            ids_d = torch.from_numpy(ids).to(self.device)
            states = self.text(ids_d, torch.ones(ids.shape, dtype=torch.bool, device=self.device))
            last = states[-1][torch.arange(len(captions), device=self.device), torch.from_numpy(eot).to(self.device)]
            feats = torch.nn.functional.linear(self.text.ln(last.to(torch.bfloat16)), self.text_proj).float()
            self.recorded.setdefault("text", []).append(feats)
            return feats

        return image_encoder, text_encoder


def path_s1_data(sizes: dict = S_SIZES) -> dict:
    """S1's stand-in for WMT16 En-De newstest2016 (seed ``seed``), from R1's generator: ``s1_pairs``
    references over a Zipf vocabulary of ``s1_vocab`` word types, lognormal lengths of mean ``s1_mean_words``
    words, hypotheses by word edits and one phrase moved a segment."""
    rng = np.random.RandomState(sizes["seed"])
    v = sizes["s1_vocab"]
    vocab, p = _r_vocab(rng, v, upper=False, marks=True), _r_zipf(v)
    ids = _r_sentences(rng, v, p, _r_lengths(rng, sizes["s1_pairs"], sizes["s1_mean_words"], 1, sizes["s1_max_words"]))
    hyp_ids = _r_hypotheses(rng, ids, v, p, (0.08, 0.05, 0.05), move=True)
    return {"refs": [" ".join(vocab[x]) for x in ids], "hyps": [" ".join(vocab[x]) for x in hyp_ids]}


def bert_score_np(p_emb: np.ndarray, p_mask: np.ndarray, t_emb: np.ndarray, t_mask: np.ndarray,
                  p_w=None, t_w=None, chunk: int = 64) -> dict:
    """BERTScore's greedy matching in float64 numpy: cosine of unit token vectors, each real token's best
    match over the other side's real tokens, weighted means (uniform, or idf), F1 (0 where undefined)."""
    out = {"precision": [], "recall": [], "f1": []}
    for lo in range(0, p_emb.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        pm, tm = p_mask[sl] > 0, t_mask[sl] > 0
        p = p_emb[sl].astype(np.float64)
        t = t_emb[sl].astype(np.float64)
        p = p / np.maximum(np.linalg.norm(p, axis=-1, keepdims=True), 1e-12)
        t = t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
        cos = np.where(pm[:, :, None] & tm[:, None, :], p @ t.transpose(0, 2, 1), -np.inf)
        wp = (p_w[sl] if p_w is not None else 1.0) * pm
        wt = (t_w[sl] if t_w is not None else 1.0) * tm
        with np.errstate(invalid="ignore", divide="ignore"):
            best_p = np.where(tm.any(-1, keepdims=True), cos.max(2), 0.0)
            best_t = np.where(pm.any(-1, keepdims=True), cos.max(1), 0.0)
            prec = np.where(pm.any(-1), (np.where(pm, best_p, 0) * wp).sum(-1) / np.maximum(wp.sum(-1), 1e-300), 0.0)
            rec = np.where(tm.any(-1), (np.where(tm, best_t, 0) * wt).sum(-1) / np.maximum(wt.sum(-1), 1e-300), 0.0)
            f1 = np.nan_to_num(2 * prec * rec / (prec + rec))
        for k, v in (("precision", prec), ("recall", rec), ("f1", f1)):
            out[k].append(v)
    return {k: np.concatenate(v) for k, v in out.items()}


def idf_np(ids: np.ndarray, mask: np.ndarray, table_ids: np.ndarray, table_mask: np.ndarray) -> np.ndarray:
    """Each position's idf over the reference corpus: log((N + 1) / (df + 1)), log(N + 1) for unseen ids."""
    n = table_ids.shape[0]
    df: dict = {}
    for row, m in zip(table_ids, table_mask):
        for tok in set(row[m > 0].tolist()):
            df[tok] = df.get(tok, 0) + 1
    return np.vectorize(lambda t: np.log((n + 1) / (df.get(int(t), 0) + 1)))(ids).astype(np.float64)


def _s_pad(x: np.ndarray, width: int, axis: int) -> np.ndarray:
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, width - x.shape[axis])
    return np.pad(x, pad)


def s1_oracle(recorded: list, layer_stacked: bool, weights=None) -> dict:
    """S1's float64 scores from the embeddings the metric's encoder returned (preds, then targets), padded to
    one width; with ``layer_stacked``, every layer's."""
    (pe, pm), (te, tm) = ((e.cpu().numpy(), m) for e, m in recorded)
    ax = 2 if layer_stacked else 1
    width = max(pe.shape[ax], te.shape[ax])
    pe, te = _s_pad(pe, width, ax), _s_pad(te, width, ax)
    pm, tm = _s_pad(pm, width, 1), _s_pad(tm, width, 1)
    pw = tw = None
    if weights is not None:
        pw, tw = (_s_pad(w, width, 1)[:, :width] for w in weights)
    if not layer_stacked:
        return bert_score_np(pe, pm, te, tm, pw, tw)
    per_layer = [bert_score_np(pe[:, k], pm, te[:, k], tm, pw, tw) for k in range(pe.shape[1])]
    return {key: np.stack([r[key] for r in per_layer]) for key in per_layer[0]}


def _s_scores_close(name: str, got: dict, want: dict, tol: float = S_TOL) -> float:
    worst = 0.0
    for key in ("precision", "recall", "f1"):
        g = got[key].cpu().numpy().astype(np.float64)
        err = float(np.max(np.abs(g - want[key]))) if g.size else 0.0
        if g.shape != want[key].shape or not err <= tol:
            raise AssertionError(f"{name} {key}: {err!r} off float64 (allowed {tol})")
        worst = max(worst, err)
    return worst


def infolm_bags_np(probs: torch.Tensor, mask: np.ndarray, weights, chunk: int = 100) -> np.ndarray:
    """InfoLM's bags in float64 on the host: each sentence's weighted mean of its real positions'
    distributions."""
    out = []
    for lo in range(0, probs.shape[0], chunk):
        p = probs[lo:lo + chunk].double().cpu().numpy()
        w = mask[lo:lo + chunk].astype(np.float64) * (weights[lo:lo + chunk] if weights is not None else 1.0)
        out.append(np.einsum("nlv,nl->nv", p, w) / np.maximum(w.sum(1), 1e-12)[:, None])
    return np.concatenate(out)


def infolm_measure_np(measure: str, p: np.ndarray, q: np.ndarray, a, b) -> tuple:
    """One information measure per sentence in float64 (JAX's conventions: kl sign-flipped, beta the AB
    divergence at alpha 1, renyi's q^a p^(1-a), fisher-rao's clipped cosine), and the magnitude of the terms it
    combines, which scales its float32 rounding."""
    with np.errstate(divide="ignore", invalid="ignore"):
        if measure == "kl_divergence":
            return (q * (np.log(p) - np.log(q))).sum(-1), (q * (np.abs(np.log(p)) + np.abs(np.log(q)))).sum(-1)
        if measure == "alpha_divergence":
            s = (q**a * p ** (1 - a)).sum(-1)
            return (1 - s) / (a * (a - 1)), (1 + s) / abs(a * (a - 1))
        if measure in ("beta_divergence", "ab_divergence"):
            a = 1.0 if measure == "beta_divergence" else a
            t = (np.log((q ** (a + b)).sum(-1)) / (b * (a + b)), np.log((p ** (a + b)).sum(-1)) / (a * (a + b)),
                 np.log((q**a * p**b).sum(-1)) / (a * b))
            return t[0] + t[1] - t[2], sum(np.abs(x) for x in t)
        if measure == "renyi_divergence":
            v = np.log((q**a * p ** (1 - a)).sum(-1)) / (a - 1)
            return v, np.abs(v) + 1 / abs(a - 1)
        if measure == "l1_distance":
            return np.abs(p - q).sum(-1), p.sum(-1) + q.sum(-1)
        if measure == "l2_distance":
            return np.sqrt(((p - q) ** 2).sum(-1)), np.sqrt(((p + q) ** 2).sum(-1))
        if measure == "l_infinity_distance":
            return np.abs(p - q).max(-1), np.maximum(p, q).max(-1)
        x = np.sqrt(p * q).sum(-1)
        return 2 * np.arccos(np.clip(x, 0, 1)), 2 * x / np.sqrt(np.maximum(1 - x**2, 1e-12))


def infolm_bound(scale: np.ndarray, a, b, length: int, vocab: int, n: int) -> float:
    """The first-order float32 bound of the corpus InfoLM (PERF.md §2): each bag element within ``(L + 2)u``
    relative (a sum of ``L`` positive terms and one division), the measure's own reduction over the
    vocabulary within ``(ceil(log2 V) + K_SERIAL)u`` of its terms' magnitude, powers scaling the bags' error by
    their exponents, and the mean over ``n`` sentences ``ceil(log2 n)u`` more."""
    k = (length + 2) * (1 + abs(a or 0.0) + abs(b or 0.0)) + int(np.ceil(np.log2(vocab))) + K_SERIAL
    return float((k * U32 * scale).mean() + int(np.ceil(np.log2(max(n, 2)))) * U32 * np.abs(scale).mean())


def clip_scores_np(img: np.ndarray, txt: np.ndarray) -> np.ndarray:
    img = img.astype(np.float64)
    txt = txt.astype(np.float64)
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    return 100 * (img * txt).sum(-1)


def clip_iqa_np(img: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """CLIP-IQA's probabilities in float64: per prompt pair the softmax of the two 100-scaled cosines."""
    img = img.astype(np.float64) / np.linalg.norm(img, axis=-1, keepdims=True)
    anchors = anchors.astype(np.float64) / np.linalg.norm(anchors, axis=-1, keepdims=True)
    logits = (100 * img @ anchors.T).reshape(img.shape[0], -1, 2)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True))[:, :, 0]


def _s_line(updates, compute_ms, peak, extra: str = "") -> str:
    first, rest = updates
    return f"update {rest:.3f} ms (the first {first:.3f}), compute {compute_ms:.3f} ms, peak +{peak:.3f} GiB{extra}"


def run_path_s1(device, tier_name: str, models: StandInEncoders, data: dict, baseline: str, sizes: dict = S_SIZES):
    """S1 on one tier: ``BERTScore(num_layers=17)`` with ``idf=False`` and ``idf=True`` over every pair in
    updates of ``batch``, and ``all_layers=True`` (a ``layer_stacked`` encoder, the 25-row baseline) over the
    first ``s1_layers_pairs``; on the graph tier each against the float64 matching of the embeddings its
    encoder returned (the eager tier must give the same bits). Then one batch's matching timed against its
    bytes bound. Returns ({name: value}, {name: line}, worst errors)."""
    import torchmetrics_tpu_torch.text as tt
    from torchmetrics_tpu_torch.functional.text.bert import _bert_score_from_embeddings

    b = sizes["batch"]
    values, lines, errors = {}, {}, {}
    variants = {"idf=False": ({}, sizes["s1_pairs"]), "idf=True": ({"idf": True}, sizes["s1_pairs"]),
                "all_layers=True, baseline": ({"all_layers": True, "rescale_with_baseline": True,
                                              "baseline_path": baseline}, sizes["s1_layers_pairs"])}
    for name, (kwargs, n) in variants.items():
        stacked = kwargs.get("all_layers", False)
        m = tt.BERTScore(encoder=models.bert_score_encoder(stacked), tokenize=models.s1_tokenize,
                         num_layers=None if stacked else sizes["num_layers"], device=device, **kwargs)
        models.recorded.pop("s1", None)
        feeds = [(data["hyps"][lo:lo + b], data["refs"][lo:lo + b]) for lo in range(0, n, b)]
        value, upd, comp, peak, _ = _q_steps(m, [(f, {}) for f in feeds])
        values[name] = value
        if tier_name != "graph":
            models.recorded.pop("s1")
            lines[name] = _s_line(upd, comp, peak, f" over {n} pairs")
            continue
        weights = None
        if kwargs.get("idf"):
            t_ids, t_mask = models.s1_tokenize(data["refs"][:n])
            p_ids, p_mask = models.s1_tokenize(data["hyps"][:n])
            weights = (idf_np(p_ids, p_mask, t_ids, t_mask), idf_np(t_ids, t_mask, t_ids, t_mask))
        want = s1_oracle(models.recorded.pop("s1"), stacked, weights)
        if stacked:
            rows = _load_baseline_np(baseline)[: want["f1"].shape[0]]
            want = {k: (want[k] - rows[:, i, None]) / (1 - rows[:, i, None]) for i, k in enumerate(("precision", "recall", "f1"))}
        errors[name] = _s_scores_close(f"path S1 {name}", value, want)
        lines[name] = _s_line(upd, comp, peak, f" over {n} pairs; error {errors[name]:.3g} (allowed {S_TOL})")
    # one update's worth of matching: a batch of ``batch`` pairs at S1's widest padded length
    enc = models.bert_score_encoder(False)
    (pe, pm), (te, tm) = enc(data["hyps"][:b]), enc(data["refs"][:b])
    models.recorded.pop("s1", None)
    width = max(pe.shape[1], te.shape[1])
    pe, te = (torch.nn.functional.pad(e, (0, 0, 0, width - e.shape[1])) for e in (pe, te))
    pm, tm = (torch.nn.functional.pad(x, (0, width - x.shape[1])) for x in (pm, tm))
    if device.type == "cuda":
        ms = time_ms(lambda: _bert_score_from_embeddings(pe, pm, te, tm), 20)
        n_bytes = (pe.numel() + te.numel()) * 4 + (pm.numel() + tm.numel()) * 8 + 3 * b * 4
        t_bound, _ = bound(n_bytes, 0)
        lines["matching"] = (f"one batch of {b} pairs at L = {width}, d = {pe.shape[-1]}: {ms:.4f} ms of device time"
                             f" against its bytes bound {t_bound:.4f} ms")
    return values, lines, errors


def _load_baseline_np(path: str) -> np.ndarray:
    rows = np.loadtxt(path, delimiter=",", skiprows=1)
    return rows[:, 1:]


def run_path_s2(device, tier_name: str, models: StandInEncoders, data: dict, sizes: dict = S_SIZES):
    """S2 on one tier: ``InfoLM(idf=True, temperature=0.25)`` with KL over the first ``s2_pairs`` in updates of
    ``batch``, then the other eight measures through ``infolm`` on the same distributions (the masked LM
    cached per sentence list); each within its float32 bound of float64 numpy on the same distributions."""
    import torchmetrics_tpu_torch.functional.text as tft
    import torchmetrics_tpu_torch.text as tt

    n, b = sizes["s2_pairs"], sizes["batch"]
    hyps, refs = data["hyps"][:n], data["refs"][:n]
    cache = {}

    def cached_lm(sentences):
        key = tuple(sentences)
        if key not in cache:
            cache[key] = models.masked_lm(sentences)
        return cache[key]

    values, lines, errors = {}, {}, {}
    t_ids, t_mask = models.s2_tokenize(refs)
    p_ids, p_mask = models.s2_tokenize(hyps)
    weights = (idf_np(p_ids, p_mask, p_ids, p_mask), idf_np(t_ids, t_mask, t_ids, t_mask))
    bags = None
    for measure, a, beta in S_MEASURES:
        t0 = time.perf_counter()
        kwargs = {"information_measure": measure, "alpha": a, "beta": beta, "idf": True, "temperature": 0.25,
                  "masked_lm": cached_lm, "tokenize": models.s2_tokenize, "return_sentence_level_score": True}
        if measure == "kl_divergence":
            m = tt.InfoLM(device=device, **kwargs)
            (corpus, sentence), upd, comp, peak, _ = _q_steps(
                m, [((hyps[lo:lo + b], refs[lo:lo + b]), {}) for lo in range(0, n, b)])
            extra = _s_line(upd, comp, peak)
        else:
            corpus, sentence = tft.infolm(hyps, refs, device=device, **kwargs)
            sync()
            extra = f"infolm on the cached distributions {(time.perf_counter() - t0) * 1e3:.1f} ms"
        values[measure] = (corpus, sentence)
        if tier_name != "graph":
            lines[measure] = extra
            continue
        if bags is None:
            pp, tp = cache[tuple(hyps)][0], cache[tuple(refs)][0]
            bags = (infolm_bags_np(pp, p_mask, weights[0]), infolm_bags_np(tp, t_mask, weights[1]))
        want, scale = infolm_measure_np(measure, bags[0], bags[1], a, beta)
        allowed = infolm_bound(scale, a, beta, sizes["s2_max_length"], sizes["bert"]["vocab"], n)
        errors[measure] = check_rel(f"path S2 {measure}", float(corpus), float(np.mean(want)), tol=S_TOL, bound=allowed)
        lines[measure] = (f"{extra}; corpus {float(corpus):.6g}, error {errors[measure]:.3g} (allowed"
                          f" {max(S_TOL * abs(float(np.mean(want))), allowed):.3g})")
    return values, lines, errors


def path_s3_images(device, sizes: dict, index: int, n: int, floats: bool = False):
    """``n`` seeded stand-in images of 3 x 224 x 224 for batch ``index``, drawn on ``device``: uint8 (S3) or
    floats in [0, 1] (S4)."""
    gen = torch.Generator(device=device).manual_seed(sizes["seed"] * 7919 + index * 2 + int(floats))
    side = sizes["vit"]["image"]
    if floats:
        return torch.rand((n, 3, side, side), device=device, generator=gen)
    return torch.randint(0, 256, (n, 3, side, side), device=device, generator=gen, dtype=torch.uint8)


def run_path_s34(device, tier_name: str, models: StandInEncoders, data: dict, sizes: dict = S_SIZES):
    """S3: ``CLIPScore`` over ``s3_images`` seeded uint8 images with one caption each (S1's references) in
    updates of ``batch``; S4: ``CLIPImageQualityAssessment`` over ``s4_images`` float images in [0, 1] with
    three prompt pairs and ``data_range=1.0``. Each against float64 on the features its encoders returned."""
    import torchmetrics_tpu_torch.multimodal as tm

    b = sizes["batch"]
    values, lines, errors = {}, {}, {}
    models.recorded.pop("image", None)
    models.recorded.pop("text", None)
    n3 = sizes["s3_images"]
    captions = [data["refs"][i % len(data["refs"])] for i in range(n3)]
    m = tm.CLIPScore(model_name_or_path=models.clip_encoders(True), device=device)
    feeds = [((list(path_s3_images(device, sizes, i, min(b, n3 - i * b))), captions[i * b:(i + 1) * b]), {})
             for i in range(-(-n3 // b))]
    value, upd, comp, peak, _ = _q_steps(m, feeds)
    del feeds
    img = torch.cat(models.recorded.pop("image")).cpu().numpy()
    txt = torch.cat(models.recorded.pop("text")).cpu().numpy()
    scores = clip_scores_np(img, txt)
    state = m.metric_state
    allowed = gamma(-(-n3 // b), b) * float(np.abs(scores).sum()) + S_TOL * abs(float(scores.sum()))
    errors["CLIPScore sum"] = check_rel("path S3 CLIPScore's score sum", float(state["score"]), float(scores.sum()),
                                        tol=S_TOL, bound=allowed)
    if int(state["n_samples"]) != n3:
        raise AssertionError(f"path S3: {int(state['n_samples'])} samples counted, {n3} fed")
    errors["CLIPScore"] = check_rel("path S3 CLIPScore", float(value), max(float(scores.mean()), 0.0), tol=S_TOL,
                                    bound=allowed / n3)
    values["CLIPScore"] = value
    lines["CLIPScore"] = _s_line(upd, comp, peak,
                                 f" over {n3} images; mean 100 cos {float(scores.mean()):.6f}, state error"
                                 f" {errors['CLIPScore sum']:.3g}")
    n4 = sizes["s4_images"]
    m = tm.CLIPImageQualityAssessment(model_name_or_path=models.clip_encoders(False), data_range=1.0,
                                      prompts=S_IQA_PROMPTS, device=device)
    feeds = [((path_s3_images(device, sizes, i, min(b, n4 - i * b), floats=True),), {}) for i in range(-(-n4 // b))]
    value, upd, comp, peak, _ = _q_steps(m, feeds)
    del feeds
    anchors = models.recorded.pop("text")[0].cpu().numpy()
    img = torch.cat(models.recorded.pop("image")).cpu().numpy()
    want = clip_iqa_np(img, anchors)
    got = np.stack([value[k].cpu().numpy() for k in value], 1).astype(np.float64)
    errors["CLIP-IQA"] = float(np.abs(got - want).max())
    if not errors["CLIP-IQA"] <= S_TOL or got.shape != (n4, 3):
        raise AssertionError(f"path S4 CLIP-IQA: {errors['CLIP-IQA']!r} off float64 (allowed {S_TOL}), shape {got.shape}")
    values["CLIP-IQA"] = value
    lines["CLIP-IQA"] = _s_line(upd, comp, peak,
                                f" over {n4} images, prompts {list(value)}; error {errors['CLIP-IQA']:.3g}")
    return values, lines, errors


def run_path_s(device, card: str, sizes: dict = S_SIZES):
    """Path S: the stand-in models and data, then every kernel's count set to 0 and S1-S4 on the graph tier and
    on the eager tier; the tiers bit-equal, every value held to float64. No part launches K1, K2 or K3.
    Returns the seconds S took."""
    import tempfile

    from torchmetrics_tpu_torch.ops.bincount import LaunchCounter

    started = time.perf_counter()
    free_device_memory()
    models = StandInEncoders(device, sizes)
    data = path_s1_data(sizes)
    sync()
    print(f"path S: stand-in models and data in {time.perf_counter() - started:.1f} s (S1 {len(data['refs'])} pairs,"
          f" {sum(len(r.split()) for r in data['refs']):,} reference words)")
    for counter in LaunchCounter.ALL:
        counter.launches = 0
    res, errors = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        baseline = os.path.join(tmp, "baseline.csv")
        rows = sizes["roberta"]["layers"] + 1
        with open(baseline, "w") as f:
            f.write("LAYER,P,R,F\n" + "".join(f"{i},{0.80 + 0.004 * i:.4f},{0.81 + 0.004 * i:.4f},{0.805 + 0.004 * i:.4f}\n"
                                              for i in range(rows)))
        for tier_name in ("graph", "eager"):
            with tier(tier_name):
                t_tier = time.perf_counter()
                v1, l1, e1 = run_path_s1(device, tier_name, models, data, baseline, sizes)
                v2, l2, e2 = run_path_s2(device, tier_name, models, data, sizes)
                v3, l3, e3 = run_path_s34(device, tier_name, models, data, sizes)
                for part, lines in (("S1", l1), ("S2", l2), ("S3/S4", l3)):
                    for label, line in lines.items():
                        print(f"path {part} [{card}] {label}, {tier_name} tier: {line}")
                print(f"path S [{card}] {tier_name} tier: {time.perf_counter() - t_tier:.1f} s")
                res[tier_name] = _bits({**v1, **v2, **v3})
                if tier_name == "graph":
                    errors = {**e1, **e2, **e3}
    same_on_both_tiers("path S", res["graph"], res["eager"])
    launches = {k: c.launches for k, c in kernel_counters().items()}
    if any(launches.values()):
        raise AssertionError(f"path S launched a kernel: {launches}")
    seconds = time.perf_counter() - started
    print(f"path S [{card}]: worst errors against float64: " + ", ".join(f"{k} {e:.3g}" for k, e in errors.items()))
    print(f"path S [{card}]: reduced: S2 over the first {sizes['s2_pairs']} of S1's {sizes['s1_pairs']} pairs; S1's"
          f" all_layers variant over the first {sizes['s1_layers_pairs']} (the whole set's 25 stacked float32 states"
          f" would hold 2 x 37 GB)")
    print(f"path S [{card}]: both tiers bit-equal, kernel launches {launches}; {seconds:.1f} s")
    return seconds


# ------------------------------------------------------------------ path T: detection
T_TOL = 1e-6
#: path T's full sizes; the tests pass smaller ones. T1 COCO val2017 (5,000 images, 80 classes, 36,781
#: ground-truth boxes, up to 100 detections an image), T2 its first ``t2_images`` at 480 x 640 with polygon
#: masks, T3 COCO panoptic val2017 (5,000 images at 480 x 640, 80 things, 53 stuffs). ``workers`` host
#: processes compute the oracles meanwhile (0: in this process)
T_SIZES = {"t1_images": 5000, "t1_classes": 80, "t1_boxes": 36_781, "t1_dets": 100, "batch": 64, "hw": (480, 640),
           "t2_images": 200, "t3_images": 5000, "t3_batch": 16, "t3_things": 80, "t3_stuffs": 53, "t3_plain": 50,
           "t3_functional": 500, "seed": 91, "workers": 5}
#: COCO's area ranges (small below 32², large above 96²) and its share of each in val2017's boxes
T_AREA_MIX = (0.41, 0.34, 0.25)
T_IOU_CLASSES = {"IoU": ("IntersectionOverUnion", "iou"), "GIoU": ("GeneralizedIntersectionOverUnion", "giou"),
                 "DIoU": ("DistanceIntersectionOverUnion", "diou"), "CIoU": ("CompleteIntersectionOverUnion", "ciou")}
#: the device memory (GiB) the matcher may keep after path T's evaluations are gone: its one graph
T_MATCH_HELD_GIB = 1.0
T_MAP_KEYS = ("map", "map_50", "map_75", "map_small", "map_medium", "map_large", "mar_1", "mar_10", "mar_100",
              "mar_small", "mar_medium", "mar_large")


def _t_boxes(rng, n: int, hw: tuple, mix=T_AREA_MIX) -> np.ndarray:
    """``n`` xyxy boxes inside an ``hw`` image, their areas drawn from COCO's small/medium/large mix."""
    h_img, w_img = hw
    kind = rng.choice(3, n, p=mix)
    lo = np.array([16.0, 32.0**2, 96.0**2])[kind]
    hi = np.array([32.0**2, 96.0**2, 0.5 * h_img * w_img])[kind]
    area = np.exp(rng.uniform(np.log(lo), np.log(hi)))
    aspect = np.exp(rng.normal(0.0, 0.5, n))
    w = np.minimum(np.sqrt(area * aspect), w_img - 1.0)
    h = np.minimum(np.sqrt(area / aspect), h_img - 1.0)
    x = rng.uniform(0, w_img - w)
    y = rng.uniform(0, h_img - h)
    return np.stack([x, y, x + w, y + h], axis=1).astype(np.float32)


def path_t1_data(sizes: dict = T_SIZES) -> dict:
    """T1's stand-in COCO val2017 (seed ``seed``): per image, ground-truth boxes (a negative binomial count of
    mean 36,781 / 5,000, a Zipf class mix, COCO's area mix, 1% ``iscrowd``) and ``t1_dets`` detections: each
    ground truth found with probability 0.85 at a jitter of a tenth of its size (score Beta(4, 2)), a tenth
    found twice (the copy at half the score), and false positives to fill (70% of the image's classes, score
    Beta(1, 5)). Returns lists of numpy arrays, one entry an image."""
    rng = np.random.RandomState(sizes["seed"])
    n_img, n_cls, hw = sizes["t1_images"], sizes["t1_classes"], sizes["hw"]
    mean = sizes["t1_boxes"] / n_img
    counts = rng.negative_binomial(1.5, 1.5 / (1.5 + mean), n_img)
    while counts.sum() != sizes["t1_boxes"]:  # the set's exact box count
        i = rng.randint(n_img)
        counts[i] = max(0, counts[i] + (1 if counts.sum() < sizes["t1_boxes"] else -1))
    p_cls = 1.0 / np.arange(1, n_cls + 1) ** 1.1
    p_cls /= p_cls.sum()
    out = {k: [] for k in ("gt_boxes", "gt_labels", "gt_crowd", "det_boxes", "det_scores", "det_labels")}
    for n in counts:
        gt = _t_boxes(rng, n, hw)
        labels = rng.choice(n_cls, n, p=p_cls)
        found = rng.rand(n) < 0.85
        twice = found & (rng.rand(n) < 0.1)
        src = np.concatenate([np.flatnonzero(found), np.flatnonzero(twice)])
        size = np.repeat(np.maximum(gt[src, 2:] - gt[src, :2], 1.0), 2, axis=1)
        jitter = gt[src] + rng.normal(0, 0.1, (src.size, 4)).astype(np.float32) * size
        scores = rng.beta(4, 2, src.size)
        scores[np.flatnonzero(found).size:] *= 0.5
        n_fp = max(0, sizes["t1_dets"] - src.size)
        own = rng.rand(n_fp) < 0.7
        fp_labels = np.where(own & (n > 0), labels[rng.randint(0, max(n, 1), n_fp)] if n else 0,
                             rng.randint(0, n_cls, n_fp))
        det = np.concatenate([jitter, _t_boxes(rng, n_fp, hw)])[: sizes["t1_dets"]]
        order = rng.permutation(det.shape[0])
        out["gt_boxes"].append(gt)
        out["gt_labels"].append(labels.astype(np.int64))
        out["gt_crowd"].append((rng.rand(n) < 0.01).astype(np.int64))
        out["det_boxes"].append(np.clip(det, 0, None).astype(np.float32)[order])
        out["det_scores"].append(np.concatenate([scores, rng.beta(1, 5, n_fp)])[: sizes["t1_dets"]].astype(np.float32)[order])
        out["det_labels"].append(np.concatenate([labels[src], fp_labels])[: sizes["t1_dets"]].astype(np.int64)[order])
    return out


def path_t2_masks(boxes: list, seed: int, hw: tuple) -> list:
    """A seeded convex polygon in each box (10 vertices at sorted random angles on the box's inscribed
    ellipse), rasterised at ``hw`` by pixel centres, one span a row: per image a bool array ``(n, H, W)``."""
    rng = np.random.RandomState(seed)
    out = []
    for img in boxes:
        masks = np.zeros((img.shape[0],) + tuple(hw), bool)
        angles = np.sort(rng.uniform(0, 2 * np.pi, (img.shape[0], 10)), axis=1)
        for k, (x0, y0, x1, y1) in enumerate(img.astype(np.float64)):
            xa, ya = int(max(0, np.floor(x0))), int(max(0, np.floor(y0)))
            xb, yb = int(min(hw[1], np.ceil(x1))), int(min(hw[0], np.ceil(y1)))
            if xb <= xa or yb <= ya:
                continue
            vx = (x0 + x1) / 2 + (x1 - x0) / 2 * np.cos(angles[k])
            vy = (y0 + y1) / 2 + (y1 - y0) / 2 * np.sin(angles[k])
            ex, ey = np.roll(vx, -1), np.roll(vy, -1)
            rows = np.arange(ya, yb)[:, None] + 0.5
            within = (rows >= np.minimum(vy, ey)) & (rows < np.maximum(vy, ey))
            with np.errstate(divide="ignore", invalid="ignore"):
                xs = vx + (rows - vy) / (ey - vy) * (ex - vx)
            left = np.where(within, xs, np.inf).min(1)[:, None]
            right = np.where(within, xs, -np.inf).max(1)[:, None]
            cols = np.arange(xa, xb)[None, :] + 0.5
            masks[k, ya:yb, xa:xb] = (cols >= left) & (cols <= right)
        out.append(masks)
    return out


def box_iou_iod_np(det: np.ndarray, gt: np.ndarray):
    """Box IoU and intersection over the detection's area in float32, operation by operation as COCO's
    corner algebra writes them (the order the port's float32 kernels round in)."""
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, np.float32(0), None)
    inter = wh[..., 0] * wh[..., 1]
    area_d = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    area_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = (area_d[:, None] + area_g[None, :]) - inter
    iou = np.where(union > 0, inter / np.maximum(union, np.float32(1e-9)), np.float32(0))
    iod = np.where(area_d[:, None] > 0, inter / np.maximum(area_d[:, None], np.float32(1e-9)), np.float32(0))
    return iou.astype(np.float32), iod.astype(np.float32)


def mask_iou_iod_np(det: np.ndarray, gt: np.ndarray):
    """Mask IoU and IoD from whole-number pixel counts."""
    d = det.reshape(det.shape[0], int(np.prod(det.shape[1:]))).astype(np.float32)
    g = gt.reshape(gt.shape[0], int(np.prod(gt.shape[1:]))).astype(np.float32)
    inter = d @ g.T
    area_d, area_g = d.sum(1), g.sum(1)
    union = area_d[:, None] + area_g[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, np.float32(1)), np.float32(0))
    iod = np.where(area_d[:, None] > 0, inter / np.maximum(area_d[:, None], np.float32(1)), np.float32(0))
    return iou.astype(np.float32), iod.astype(np.float32)


def greedy_match_np(iou: np.ndarray, matchable: np.ndarray, thresholds: np.ndarray) -> np.ndarray:
    """COCO's greedy matching of one (image, class) group: the detections (rows of ``iou``) in score order,
    each taking the free matchable ground truth of largest IoU (the first on ties) where that IoU clears the
    threshold. ``matchable`` is ``(A, G)``; returns the ``(A, T, D)`` match table."""
    n_det, n_gt = iou.shape
    table = np.zeros((matchable.shape[0], thresholds.shape[0], n_det), bool)
    taken = np.zeros((matchable.shape[0], thresholds.shape[0], n_gt), bool)
    for d in range(n_det):
        if not n_gt:
            break
        cand = np.where(matchable[:, None, :] & ~taken, iou[d][None, None, :], -1.0)
        m = cand.argmax(-1)
        ok = cand.max(-1) > thresholds[None, :]
        table[:, :, d] = ok
        a, t = np.nonzero(ok)
        taken[a, t, m[a, t]] = True
    return table


def coco_eval_np(dets: dict, gts: dict, geom: str, thresholds: np.ndarray, max_dets=(1, 10, 100), micro=False,
                 rec_thresholds=np.linspace(0.0, 1.0, 101).round(2)):
    """COCO's evaluation from the protocol, in plain numpy: per (image, class) group the detections by
    descending score (stable) cut to the largest ``max_dets``, ground truths outside an area range or
    ``iscrowd`` ignored and never matched, the greedy matcher, unmatched detections outside the range or
    inside a crowd (intersection over own area of at least the threshold) ignored; precision with its
    monotone envelope read at 101 recall points. Returns (the ``(P, A, T, D)`` tables in group order, the
    summary dict)."""
    ranges = np.array([[0.0, 1e5**2], [0.0, 32.0**2], [32.0**2, 96.0**2], [96.0**2, 1e5**2]])
    n_img = len(gts["labels"])
    labels_d = [np.zeros_like(x) if micro else x for x in dets["labels"]]
    labels_g = [np.zeros_like(x) if micro else x for x in gts["labels"]]
    classes = sorted(set(np.concatenate(labels_d + labels_g).tolist())) if n_img else []
    by_class = {c: [] for c in classes}
    for i in range(n_img):
        for c in sorted(set(labels_d[i].tolist()) | set(labels_g[i].tolist())):
            d_idx, g_idx = np.flatnonzero(labels_d[i] == c), np.flatnonzero(labels_g[i] == c)
            by_class[c].append((c, i, d_idx[np.argsort(-dets["scores"][i][d_idx], kind="stable")][:max_dets[-1]], g_idx))
    groups = [g for c in classes for g in by_class[c]]  # class by class, each class's images in order
    tables, records = [], {c: [] for c in classes}
    for c, i, d_idx, g_idx in groups:
        dg, gg = dets[geom][i][d_idx], gts[geom][i][g_idx]
        if not g_idx.size:  # nothing to match: every detection a false positive unless outside the range
            d_area = (((dg[:, 2] - dg[:, 0]) * (dg[:, 3] - dg[:, 1])) if geom == "boxes" else dg.sum((1, 2))).astype(np.float64)
            table = np.zeros((4, len(thresholds), d_idx.size), bool)
            d_out = (d_area[None, :] < ranges[:, :1]) | (d_area[None, :] > ranges[:, 1:])
            tables.append(table)
            records[c].append((dets["scores"][i][d_idx], table, np.broadcast_to(d_out[:, None, :], table.shape),
                               np.zeros(4, np.int64)))
            continue
        if geom == "boxes":
            iou, iod = box_iou_iod_np(dg, gg)
            d_area = ((dg[:, 2] - dg[:, 0]) * (dg[:, 3] - dg[:, 1])).astype(np.float64)
            g_area = ((gg[:, 2] - gg[:, 0]) * (gg[:, 3] - gg[:, 1])).astype(np.float64)
        else:
            iou, iod = mask_iou_iod_np(dg, gg)
            d_area = dg.sum((1, 2)).astype(np.float64)
            g_area = gg.sum((1, 2)).astype(np.float64)
        crowd = gts["crowd"][i][g_idx].astype(bool)
        g_ignore = (g_area[None, :] < ranges[:, :1]) | (g_area[None, :] > ranges[:, 1:]) | crowd[None, :]  # (A, G)
        table = greedy_match_np(iou, ~g_ignore, thresholds.astype(np.float32))  # the matcher's float32 thresholds
        tables.append(table)
        d_out = (d_area[None, :] < ranges[:, :1]) | (d_area[None, :] > ranges[:, 1:])  # (A, D)
        best_crowd = np.where(crowd[None, :], iod, 0.0).max(1) if crowd.any() else np.zeros(len(d_idx))
        absorbed = best_crowd[None, :] > thresholds[:, None] - 1e-10  # (T, D)
        ignore = ~table & (d_out[:, None, :] | absorbed[None, :, :])
        records[c].append((dets["scores"][i][d_idx], table, ignore, (~g_ignore).sum(1)))
    n_t, n_r, n_a = len(thresholds), len(rec_thresholds), 4
    precision = -np.ones((n_t, n_r, len(classes), n_a, len(max_dets)))
    recall = -np.ones((n_t, len(classes), n_a, len(max_dets)))
    for k, c in enumerate(classes):
        recs = records[c]
        for a in range(n_a):
            npig = sum(int(r[3][a]) for r in recs)
            if npig == 0:
                continue
            for mi, m in enumerate(max_dets):
                scores = np.concatenate([r[0][:m] for r in recs])
                order = np.argsort(-scores, kind="stable")
                tp_all = np.concatenate([r[1][a, :, :m] for r in recs], axis=1)[:, order]  # (T, N)
                ig_all = np.concatenate([r[2][a, :, :m] for r in recs], axis=1)[:, order]
                for t in range(n_t):
                    tp, ig = tp_all[t], ig_all[t]
                    tps, fps = np.cumsum(tp & ~ig), np.cumsum(~tp & ~ig)
                    rc = tps / npig
                    pr = tps / (tps + fps + np.finfo(np.float64).eps)
                    recall[t, k, a, mi] = rc[-1] if rc.size else 0
                    pr = np.maximum.accumulate(pr[::-1])[::-1] if pr.size else pr
                    inds = np.searchsorted(rc, rec_thresholds, side="left")
                    q = np.zeros(n_r)
                    ok = inds < rc.size
                    q[ok] = pr[inds[ok]]
                    if (~ok).any():  # COCO stops at the first recall point it cannot reach
                        q[np.argmax(~ok):] = 0
                    precision[t, :, k, a, mi] = q

    def mean_valid(x):
        v = x[x > -1]
        return float(v.mean()) if v.size else -1.0

    thr = list(np.round(thresholds, 2))
    summary = {"map": mean_valid(precision[..., 0, -1]), "map_50": mean_valid(precision[thr.index(0.5), ..., 0, -1]),
               "map_75": mean_valid(precision[thr.index(0.75), ..., 0, -1])}
    for a, name in ((1, "small"), (2, "medium"), (3, "large")):
        summary[f"map_{name}"] = mean_valid(precision[..., a, -1])
    for mi, m in enumerate(max_dets):
        summary[f"mar_{m}"] = mean_valid(recall[..., 0, mi])
    for a, name in ((1, "small"), (2, "medium"), (3, "large")):
        summary[f"mar_{name}"] = mean_valid(recall[..., a, -1])
    return tables, summary


def iou_family_np(dets: dict, gts: dict) -> dict:
    """The four IoU classes' values (labels respected) in float64 corner algebra, eps 1e-7 where the
    published DIoU and CIoU put it."""
    sums = {k: [] for k in T_IOU_CLASSES}
    for db, dl, gb, gl in zip(dets["boxes"], dets["labels"], gts["boxes"], gts["labels"]):
        d, g = db.astype(np.float64), gb.astype(np.float64)
        same = dl[:, None] == gl[None, :]
        lt, rb = np.maximum(d[:, None, :2], g[None, :, :2]), np.minimum(d[:, None, 2:], g[None, :, 2:])
        wh = np.clip(rb - lt, 0, None)
        inter = wh[..., 0] * wh[..., 1]
        area_d, area_g = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1]), (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
        union = area_d[:, None] + area_g[None, :] - inter
        elt, erb = np.minimum(d[:, None, :2], g[None, :, :2]), np.maximum(d[:, None, 2:], g[None, :, 2:])
        ewh = np.clip(erb - elt, 0, None)
        enclose = ewh[..., 0] * ewh[..., 1]
        iou_e = inter / (union + 1e-7)
        diag = ewh[..., 0] ** 2 + ewh[..., 1] ** 2 + 1e-7
        centre = ((d[:, None, :2] + d[:, None, 2:]) / 2 - (g[None, :, :2] + g[None, :, 2:]) / 2) ** 2
        diou = iou_e - centre.sum(-1) / diag
        v = (4 / np.pi**2) * (np.arctan((g[:, 2] - g[:, 0]) / (g[:, 3] - g[:, 1]))[None, :]
                              - np.arctan((d[:, 2] - d[:, 0]) / (d[:, 3] - d[:, 1]))[:, None]) ** 2
        ciou = diou - v / (1 - iou_e + v + 1e-7) * v
        values = {"IoU": inter / union, "GIoU": inter / union - (enclose - union) / enclose, "DIoU": diou, "CIoU": ciou}
        for k, val in values.items():
            sums[k].append(val[same])
    return {k: float(np.concatenate(v).mean()) for k, v in sums.items()}


def path_t_oracle(job: tuple):
    """One host oracle of path T, run in a worker process: ``("map", sizes, run)`` rebuilds the data from
    the seed and evaluates one mean-AP run in numpy; ``("iou", sizes)`` the IoU family in float64."""
    kind, sizes = job[0], job[1]
    data = path_t1_data(sizes)
    thresholds = np.linspace(0.5, 0.95, 10).round(2)
    if kind == "iou":
        return iou_family_np({"boxes": data["det_boxes"], "labels": data["det_labels"]},
                             {"boxes": data["gt_boxes"], "labels": data["gt_labels"]})
    run = job[2]
    n = sizes["t2_images"] if run.startswith("T2") else sizes["t1_images"]
    dets = {"boxes": data["det_boxes"][:n], "scores": data["det_scores"][:n], "labels": data["det_labels"][:n]}
    gts = {"boxes": data["gt_boxes"][:n], "labels": data["gt_labels"][:n], "crowd": data["gt_crowd"][:n]}
    geom = "boxes"
    if run == "T2 segm":
        dets["masks"] = path_t2_masks(dets["boxes"], sizes["seed"] + 1, sizes["hw"])
        gts["masks"] = path_t2_masks(gts["boxes"], sizes["seed"] + 2, sizes["hw"])
        geom = "masks"
    tables, summary = coco_eval_np(dets, gts, geom, thresholds, micro=run == "T1 micro")
    return [np.packbits(t) for t in tables], [t.shape for t in tables], summary


def path_t_oracles(sizes: dict = T_SIZES):
    """Path T's host oracles, submitted to ``workers`` spawned processes (or run here at 0):
    ``(pool or None, {name: future})``."""
    from concurrent.futures import Future, ProcessPoolExecutor
    import multiprocessing

    jobs = {"T1 macro": ("map", sizes, "T1 macro"), "T1 micro": ("map", sizes, "T1 micro"),
            "T2 bbox": ("map", sizes, "T2 bbox"), "T2 segm": ("map", sizes, "T2 segm"), "T1 IoU": ("iou", sizes)}
    if not sizes["workers"]:
        done = {}
        for name, job in jobs.items():
            done[name] = Future()
            done[name].set_result(path_t_oracle(job))
        return None, done
    pool = ProcessPoolExecutor(sizes["workers"], mp_context=multiprocessing.get_context("spawn"))
    return pool, {name: pool.submit(path_t_oracle, job) for name, job in jobs.items()}


class MatchRecorder:
    """Wraps ``mean_ap.match_all_groups`` for one untimed pass: each call's match table (copied to the host),
    its padded shape, wall and device time by CUDA events, and the device memory it added at its peak. The
    first call's arguments are kept when ``keep_args``, for a later replay."""

    def __init__(self, mean_ap, keep_args: bool = False) -> None:
        self.mean_ap, self.inner, self.calls, self.keep_args = mean_ap, mean_ap.match_all_groups, [], keep_args

    def __enter__(self):
        self.mean_ap.match_all_groups = self
        return self

    def __exit__(self, *exc):
        self.mean_ap.match_all_groups = self.inner
        return False

    def __call__(self, *args):
        base = _peak_start()
        timed = torch.cuda.is_available() and args[0].is_cuda
        if timed:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = self.inner(*args)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        if timed:
            end.record()
            end.synchronize()
        p, d, g = args[0].shape
        self.calls.append({"shape": (p, d, g, args[4].shape[0]), "table": out.cpu().numpy(), "wall_ms": wall,
                           "device_ms": start.elapsed_time(end) if timed else float("nan"),
                           "peak_gib": _peak_gib(base), "args": args if self.keep_args and not self.calls else None})
        return out


def _match_pass(m, mean_ap, keep_args: bool = False) -> list:
    """``m``'s compute once more, untimed, under a ``MatchRecorder``: the records of its matcher calls. The
    timed compute ran before it with nothing wrapped, so its wall holds none of the recorder's copies."""
    with MatchRecorder(mean_ap, keep_args) as rec:
        m.compute()
    return rec.calls


def _t_inputs(data: dict, device, lo: int, hi: int, masks=None):
    """Images ``lo:hi`` as the list-of-dicts inputs, on ``device``."""
    preds, target = [], []
    for i in range(lo, hi):
        p = {"boxes": data["dev"]["det_boxes"][i], "scores": data["dev"]["det_scores"][i],
             "labels": data["dev"]["det_labels"][i]}
        t = {"boxes": data["dev"]["gt_boxes"][i], "labels": data["dev"]["gt_labels"][i],
             "iscrowd": data["dev"]["gt_crowd"][i]}
        if masks is not None:
            p["masks"], t["masks"] = masks[0][i], masks[1][i]
        preds.append(p)
        target.append(t)
    return preds, target


def _to_device(data: dict, device) -> dict:
    """Each image's arrays as tensors on ``device``: views of one upload per field."""
    out = {}
    for key, arrays in data.items():
        lengths = [a.shape[0] for a in arrays]
        flat = torch.from_numpy(np.concatenate(arrays)).to(device)
        out[key] = list(torch.split(flat, lengths))
    return out


def _matcher_text(rec: dict) -> str:
    p, d, g, t = rec["shape"]
    return (f"matcher at (P, D, G, T) = ({p:,}, {d}, {g}, {t}): {rec['device_ms']:.3f} ms of device time"
            f" ({rec['wall_ms']:.3f} ms wall), peak +{rec['peak_gib']:.3f} GiB")


def path_t1_second(d1: dict, seed: int) -> dict:
    """T1's second evaluation, as a user's loop meets after another epoch: the same images and ground truths,
    5% of each image's detections dropped and every score drawn anew (seeded). Numpy, as ``path_t1_data``."""
    rng = np.random.RandomState(seed)
    out = dict(d1)
    for key in ("det_boxes", "det_scores", "det_labels"):
        out[key] = []
    for boxes, labels in zip(d1["det_boxes"], d1["det_labels"]):
        keep = rng.rand(labels.shape[0]) >= 0.05
        out["det_boxes"].append(boxes[keep])
        out["det_labels"].append(labels[keep])
        out["det_scores"].append(rng.rand(int(keep.sum())).astype(np.float32))
    return out


def run_path_t1(device, tier_name: str, data: dict, sizes: dict = T_SIZES):
    """T1 on one tier: ``MeanAveragePrecision(class_metrics=True)`` over every image in updates of ``batch``,
    one compute; the same over the second evaluation's detections (``data["dev2"]``), as a user's next
    evaluation (on the graph tier a replay of the first one's matcher graph where its block shape comes
    back); then ``(average="micro")``. Each compute is timed alone, then run once more untimed for its match
    tables. Then the four IoU classes over the same boxes. Returns ({name: value}, {name: line},
    {name: the matcher's records})."""
    import torchmetrics_tpu_torch.detection as td
    from torchmetrics_tpu_torch.detection import mean_ap

    n, b = sizes["t1_images"], sizes["batch"]
    feeds = [_t_inputs(data, device, lo, min(lo + b, n)) for lo in range(0, n, b)]
    second = [_t_inputs({"dev": data["dev2"]}, device, lo, min(lo + b, n)) for lo in range(0, n, b)]
    values, lines, records = {}, {}, {}
    for name, kwargs, batches in (("mAP class_metrics", {"class_metrics": True}, feeds),
                                  ("mAP class_metrics, second evaluation", {"class_metrics": True}, second),
                                  ("mAP micro", {"average": "micro"}, feeds)):
        m = td.MeanAveragePrecision(device=device, **kwargs)
        value, upd, comp, peak, graph = _q_steps(m, [(f, {}) for f in batches])
        records[name] = _match_pass(m, mean_ap, keep_args=name == "mAP class_metrics")
        values[name] = value
        lines[name] = _s_line(upd, comp, peak, _tier_text(graph) + "; untimed pass: "
                              + "; ".join(_matcher_text(r) for r in records[name]))
        del m
    for label, (cls, key) in T_IOU_CLASSES.items():
        m = getattr(td, cls)(device=device)
        value, upd, comp, peak, _ = _q_steps(m, [(f, {}) for f in feeds])
        values[label] = value[key]
        lines[label] = _s_line(upd, comp, peak)
    return values, lines, records


def run_path_t2(device, tier_name: str, data: dict, masks: tuple, sizes: dict = T_SIZES):
    """T2 on one tier: ``MeanAveragePrecision(iou_type=("bbox", "segm"))`` over the first ``t2_images`` in
    updates of ``batch``, one compute timed alone; then once more untimed for the match tables, with the
    mask product of its first chunk timed against its FLOP bound."""
    import torchmetrics_tpu_torch.detection as td
    from torchmetrics_tpu_torch.detection import mean_ap

    n, b = sizes["t2_images"], sizes["batch"]
    feeds = [_t_inputs(data, device, lo, min(lo + b, n), masks) for lo in range(0, n, b)]
    m = td.MeanAveragePrecision(iou_type=("bbox", "segm"), device=device)
    value, upd, comp, peak, graph = _q_steps(m, [(f, {}) for f in feeds])
    chunks = []
    inner = mean_ap._mask_iou_matrix

    def timed_product(det_flat, gt_flat):
        if not chunks and det_flat.is_cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(det_flat, gt_flat)
            end.record()
            end.synchronize()
            chunks.append((tuple(det_flat.shape), gt_flat.shape[1], start.elapsed_time(end)))
            return out
        chunks.append((tuple(det_flat.shape), gt_flat.shape[1], None))
        return inner(det_flat, gt_flat)

    mean_ap._mask_iou_matrix = timed_product
    try:
        calls = _match_pass(m, mean_ap)
    finally:
        mean_ap._mask_iou_matrix = inner
    line = _s_line(upd, comp, peak, _tier_text(graph) + f"; untimed pass: {len(chunks)} chunks of the mask product; "
                   + "; ".join(f"{kind} {_matcher_text(r)}" for kind, r in zip(("bbox", "segm"), calls)))
    if chunks and chunks[0][2] is not None:
        (n_c, cap_d, hw), cap_g, ms = chunks[0]
        flops = 2 * n_c * cap_d * cap_g * hw
        line += (f"; the first chunk's product ({n_c} groups x {cap_d} x {cap_g} x {hw:,} pixels) {ms:.3f} ms against"
                 f" its FLOP bound {flops / PEAK_SCALAR_OPS_PER_S * 1e3:.3f} ms (float32 outside the tensor cores)")
    return value, line, {"T2 bbox": calls[0], "T2 segm": calls[1]}


def check_t_map(name: str, value: dict, oracle: tuple, record: dict, prefix: str = "") -> float:
    """A mean-AP run against its oracle: the match tables exactly (padded detection slots unmatched), the
    summary within ``T_TOL``. Returns the worst summary error."""
    packed, shapes, summary = oracle
    table = record["table"]
    if table.shape[0] != len(shapes):
        raise AssertionError(f"{name}: {table.shape[0]} groups, the oracle {len(shapes)}")
    for j, (shape, bits) in enumerate(zip(shapes, packed)):
        want = np.unpackbits(bits, count=int(np.prod(shape))).reshape(shape).astype(bool)
        got = table[j]
        if not np.array_equal(got[:, :, :shape[2]], want) or got[:, :, shape[2]:].any():
            raise AssertionError(f"{name}: group {j}'s match table differs from the plain greedy matcher's")
    worst = 0.0
    for key in T_MAP_KEYS:
        got = float(value[prefix + key])
        err = abs(got - summary[key])
        if err > T_TOL:
            raise AssertionError(f"{name} {key} = {got!r}, the plain evaluation gives {summary[key]!r}")
        worst = max(worst, err)
    return worst


def path_t3_batch(device, sizes: dict, index: int):
    """T3's batch ``index``: ``t3_batch`` target and prediction maps ``(B, H, W, 2)`` (category, instance),
    int32, drawn on ``device`` from a generator seeded by the batch. A target: a 6 x 8 grid of stuff blocks,
    then up to 12 thing rectangles (instances 1, 2, ...), then 4% of the pixels an unknown category (void).
    A prediction: the target's segments, each thing shifted by up to 8 pixels, a fifth of them relabelled to
    another thing, stuff blocks relabelled with probability 0.1, and up to 3 false-positive things."""
    things, stuffs = path_t3_categories(sizes)
    h, w = sizes["hw"]
    b = min(sizes["t3_batch"], sizes["t3_images"] - index * sizes["t3_batch"])
    gen = torch.Generator(device=device).manual_seed(sizes["seed"] * 1000 + index)
    t_things = torch.tensor(things, device=device, dtype=torch.int32)
    t_stuffs = torch.tensor(stuffs, device=device, dtype=torch.int32)
    yy = torch.arange(h, device=device)[None, None, :, None]
    xx = torch.arange(w, device=device)[None, None, None, :]

    def stuff_map(blocks):
        return blocks.repeat_interleave(-(-h // 6), 1)[:, :h].repeat_interleave(-(-w // 8), 2)[:, :, :w]

    blocks = t_stuffs[torch.randint(0, len(stuffs), (b, 6, 8), device=device, generator=gen)]
    n_inst = 12
    x0 = torch.randint(0, w - 16, (b, n_inst), device=device, generator=gen)
    y0 = torch.randint(0, h - 16, (b, n_inst), device=device, generator=gen)
    bw = torch.randint(8, w // 3, (b, n_inst), device=device, generator=gen)
    bh = torch.randint(8, h // 3, (b, n_inst), device=device, generator=gen)
    present = torch.rand((b, n_inst), device=device, generator=gen) < 0.8
    cats = t_things[torch.randint(0, len(things), (b, n_inst), device=device, generator=gen)]

    def paint(cat_map, inst_map, x0_, y0_, w_, h_, cats_, present_, inst0: int):
        for k in range(x0_.shape[1]):
            inside = ((xx >= x0_[:, k, None, None, None]) & (xx < (x0_ + w_)[:, k, None, None, None])
                      & (yy >= y0_[:, k, None, None, None]) & (yy < (y0_ + h_)[:, k, None, None, None]))[:, 0]
            inside &= present_[:, k, None, None]
            cat_map = torch.where(inside, cats_[:, k, None, None], cat_map)
            inst_map = torch.where(inside, torch.full_like(inst_map, inst0 + k), inst_map)
        return cat_map, inst_map

    t_cat, t_inst = paint(stuff_map(blocks), torch.zeros((b, h, w), dtype=torch.int32, device=device), x0, y0, bw, bh,
                          cats, present, 1)
    void = torch.rand((b, h, w), device=device, generator=gen) < 0.04
    t_cat_void = torch.where(void, torch.zeros_like(t_cat), t_cat)  # category 0 is neither a thing nor a stuff
    relabel = torch.rand((b, 6, 8), device=device, generator=gen) < 0.1
    p_blocks = torch.where(relabel, t_stuffs[torch.randint(0, len(stuffs), (b, 6, 8), device=device, generator=gen)],
                           blocks)
    shift_x = torch.randint(-8, 9, (b, n_inst), device=device, generator=gen)
    shift_y = torch.randint(-8, 9, (b, n_inst), device=device, generator=gen)
    swap = torch.rand((b, n_inst), device=device, generator=gen) < 0.2
    p_cats = torch.where(swap, t_things[torch.randint(0, len(things), (b, n_inst), device=device, generator=gen)], cats)
    p_cat, p_inst = paint(stuff_map(p_blocks), torch.zeros((b, h, w), dtype=torch.int32, device=device),
                          (x0 + shift_x).clamp(0, w - 16), (y0 + shift_y).clamp(0, h - 16), bw, bh, p_cats, present, 1)
    n_fp = 3
    fx0 = torch.randint(0, w - 16, (b, n_fp), device=device, generator=gen)
    fy0 = torch.randint(0, h - 16, (b, n_fp), device=device, generator=gen)
    f_present = torch.rand((b, n_fp), device=device, generator=gen) < 0.5
    f_cats = t_things[torch.randint(0, len(things), (b, n_fp), device=device, generator=gen)]
    p_cat, p_inst = paint(p_cat, p_inst, fx0, fy0, bw[:, :n_fp], bh[:, :n_fp], f_cats, f_present, 100)
    return torch.stack([p_cat, p_inst], -1), torch.stack([t_cat_void, t_inst], -1)


def path_t3_categories(sizes: dict):
    """COCO panoptic's ids: the 80 things among 1-90 (the ten ids COCO leaves out dropped), and 53 stuffs
    spread over 92-200."""
    missing = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83}
    things = [i for i in range(1, 91) if i not in missing][: sizes["t3_things"]]
    stuffs = sorted({int(round(x)) for x in np.linspace(92, 200, sizes["t3_stuffs"])})
    return things, stuffs


def panoptic_plain_np(preds: np.ndarray, target: np.ndarray, things: set, stuffs: set, modified: bool) -> tuple:
    """Panoptic quality's sums per category from the definition, segment by segment: the stuffs' instance
    ids dropped, unknown target categories void; a pair of segments of one category matches at IoU > 0.5,
    the IoU's union leaving out each side's overlap with void; an unmatched segment counts as a FP or FN
    unless more than half of it lies on void. ``modified``: a stuff category's IoU sum takes every
    overlapping pair and its TP counts its target segments. Returns {category: [iou_sum, tp, fp, fn]}."""
    cats = sorted(things) + sorted(stuffs)
    sums = {c: [0.0, 0, 0, 0] for c in cats}
    for p, t in zip(preds, target):
        p, t = p.reshape(-1, 2).astype(np.int64), t.reshape(-1, 2).astype(np.int64)
        t_known = np.isin(t[:, 0], cats)
        p_inst = np.where(np.isin(p[:, 0], list(stuffs)), 0, p[:, 1])
        t_inst = np.where(np.isin(t[:, 0], list(stuffs)), 0, t[:, 1])
        p_seg = {(c, i): np.flatnonzero((p[:, 0] == c) & (p_inst == i)) for c, i in set(zip(p[:, 0].tolist(), p_inst.tolist()))}
        t_seg = {(c, i): np.flatnonzero((t[:, 0] == c) & (t_inst == i) & t_known)
                 for c, i in set(zip(t[:, 0][t_known].tolist(), t_inst[t_known].tolist()))}
        void = ~t_known
        matched_p, matched_t = set(), set()
        for (tc, ti), t_pix in t_seg.items():
            for (pc, pi), p_pix in p_seg.items():
                if pc != tc:
                    continue
                inter = np.intersect1d(t_pix, p_pix, assume_unique=True).size
                if not inter:
                    continue
                union = p_pix.size - int(void[p_pix].sum()) + t_pix.size - inter
                iou = inter / union
                if modified and tc in stuffs:
                    sums[tc][0] += iou
                elif iou > 0.5:
                    sums[tc][0] += iou
                    sums[tc][1] += 1
                    matched_p.add((pc, pi))
                    matched_t.add((tc, ti))
        for (tc, ti), t_pix in t_seg.items():
            if modified and tc in stuffs:
                sums[tc][1] += 1
            elif (tc, ti) not in matched_t:
                sums[tc][3] += 1
        for (pc, pi), p_pix in p_seg.items():
            if (modified and pc in stuffs) or (pc, pi) in matched_p:
                continue
            if void[p_pix].sum() / p_pix.size <= 0.5:
                sums[pc][2] += 1
    return sums


def pq_from_sums(sums: dict) -> float:
    values = [s[0] / (s[1] + 0.5 * s[2] + 0.5 * s[3]) for s in sums.values() if s[1] + 0.5 * s[2] + 0.5 * s[3] > 0]
    return float(np.mean(values)) if values else float("nan")


def run_path_t3(device, tier_name: str, sizes: dict = T_SIZES):
    """T3 on one tier: ``PanopticQuality`` and ``ModifiedPanopticQuality`` over every image in updates of
    ``t3_batch``, the maps drawn on the card batch by batch; then each functional over the first
    ``t3_functional`` images at once. Returns ({name: value}, {name: line}, the first ``t3_plain`` images'
    maps on the host)."""
    import torchmetrics_tpu_torch.detection as td
    import torchmetrics_tpu_torch.functional.detection as tfd

    things, stuffs = path_t3_categories(sizes)
    n_batches = -(-sizes["t3_images"] // sizes["t3_batch"])
    values, lines, plain = {}, {}, []
    metrics = {"PQ": td.PanopticQuality(things, stuffs, device=device),
               "modified PQ": td.ModifiedPanopticQuality(things, stuffs, device=device)}
    walls = {name: [] for name in metrics}
    base = _peak_start()
    n_plain = -(-sizes["t3_plain"] // sizes["t3_batch"])
    for index in range(n_batches):
        preds, target = path_t3_batch(device, sizes, index)
        if index < n_plain:
            plain.append((preds.cpu().numpy(), target.cpu().numpy()))
        for name, m in metrics.items():
            sync()
            t0 = time.perf_counter()
            m.update(preds, target)
            sync()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    for name, m in metrics.items():
        t0 = time.perf_counter()
        values[name] = m.compute()
        sync()
        comp = (time.perf_counter() - t0) * 1e3
        values[name + " states"] = {k: v.cpu() for k, v in m.metric_state.items()}
        lines[name] = _s_line((walls[name][0], float(np.mean(walls[name][1:]))), comp, _peak_gib(base),
                              f" over {sizes['t3_images']} images at {sizes['hw'][0]} x {sizes['hw'][1]}")
    sub = [path_t3_batch(device, sizes, i) for i in range(-(-sizes["t3_functional"] // sizes["t3_batch"]))]
    preds, target = (torch.cat([s[k] for s in sub])[: sizes["t3_functional"]] for k in (0, 1))
    del sub
    for name, fn in (("PQ functional", tfd.panoptic_quality), ("modified PQ functional", tfd.modified_panoptic_quality)):
        t0 = time.perf_counter()
        values[name] = fn(preds, target, things, stuffs)
        sync()
        lines[name] = f"one call over the first {sizes['t3_functional']} images {(time.perf_counter() - t0) * 1e3:.1f} ms"
    prefix = {name: td.PanopticQuality(things, stuffs, device=device) if name == "PQ" else
              td.ModifiedPanopticQuality(things, stuffs, device=device) for name in metrics}
    for name, m in prefix.items():  # the class over the same images as the functional
        for lo in range(0, sizes["t3_functional"], sizes["t3_batch"]):
            m.update(preds[lo:lo + sizes["t3_batch"]], target[lo:lo + sizes["t3_batch"]])
        values[name + " prefix"] = m.compute()
    return values, lines, plain


def check_t3(device, values: dict, plain: list, sizes: dict) -> dict:
    """The classes over the first ``t3_functional`` images equal the functionals over them at once (the same
    bits), and a class's sums over the first ``t3_plain`` images, on ``device``, equal the plain per-segment
    evaluation's (counts exactly, IoU sums within 1e-6 relative)."""
    import torchmetrics_tpu_torch.detection as td

    things, stuffs = path_t3_categories(sizes)
    for name in ("PQ", "modified PQ"):
        if not torch.equal(values[name + " prefix"], values[name + " functional"]):
            raise AssertionError(f"path T3 {name}: the class over the first {sizes['t3_functional']} images gives"
                                 f" {float(values[name + ' prefix'])!r}, the functional {float(values[name + ' functional'])!r}")
    preds = np.concatenate([p for p, _ in plain])[: sizes["t3_plain"]]
    target = np.concatenate([t for _, t in plain])[: sizes["t3_plain"]]
    worst = {}
    for name, modified in (("PQ", False), ("modified PQ", True)):
        want = panoptic_plain_np(preds, target, set(things), set(stuffs), modified)
        m = (td.ModifiedPanopticQuality if modified else td.PanopticQuality)(things, stuffs, device=device)
        m.update(torch.from_numpy(preds).to(device), torch.from_numpy(target).to(device))
        state = m.metric_state
        index = m.cat_id_to_continuous_id
        err = 0.0
        for cat, (iou_sum, tp, fp, fn) in want.items():
            i = index[cat]
            got = [int(state[k][i]) for k in ("true_positives", "false_positives", "false_negatives")]
            if got != [tp, fp, fn]:
                raise AssertionError(f"path T3 {name} category {cat}: TP/FP/FN {got}, the plain loop {[tp, fp, fn]}")
            e = abs(float(state["iou_sum"][i]) - iou_sum)
            if e > 1e-6 * max(1.0, iou_sum):
                raise AssertionError(f"path T3 {name} category {cat}: IoU sum {float(state['iou_sum'][i])!r}, the plain"
                                     f" loop {iou_sum!r}")
            err = max(err, e)
        value = float(m.compute())
        check_rel(f"path T3 {name} over {sizes['t3_plain']} images", value, pq_from_sums(want), tol=1e-6)
        worst[name] = err
    return worst


def run_path_t(device, card: str, sizes: dict = T_SIZES):
    """Path T: the data and the oracles started in worker processes, then every kernel's count set to 0 and
    T1-T3 on the graph tier and on the eager tier; the tiers bit-equal, the graph tier's values held to the
    oracles. No part launches K1, K2 or K3. Returns the seconds T took."""
    from torchmetrics_tpu_torch.detection import mean_ap
    from torchmetrics_tpu_torch.ops.bincount import LaunchCounter

    started = time.perf_counter()
    free_device_memory()
    d1 = path_t1_data(sizes)
    n2 = sizes["t2_images"]
    masks_np = (path_t2_masks(d1["det_boxes"][:n2], sizes["seed"] + 1, sizes["hw"]),
                path_t2_masks(d1["gt_boxes"][:n2], sizes["seed"] + 2, sizes["hw"]))
    data = {"dev": _to_device(d1, device), "dev2": _to_device(path_t1_second(d1, sizes["seed"] + 3), device)}
    masks = tuple([torch.from_numpy(m).to(device) for m in side] for side in masks_np)
    del masks_np
    t_data = time.perf_counter() - started
    pool, futures = path_t_oracles(sizes)
    try:
        print(f"path T: data in {t_data:.1f} s (T1 {sizes['t1_images']} images, {sum(map(len, d1['gt_boxes'])):,}"
              f" ground truths ({sum(int(c.sum()) for c in d1['gt_crowd'])} crowds), {sum(map(len, d1['det_boxes'])):,}"
              f" detections, {sum(map(len, data['dev2']['det_boxes'])):,} in the second evaluation; T2 {n2} images'"
              f" masks at {sizes['hw'][0]} x {sizes['hw'][1]}, on the card)")
        for counter in LaunchCounter.ALL:
            counter.launches = 0
        res, records = {}, {}
        for tier_name in ("graph", "eager"):
            with tier(tier_name):
                t_tier = time.perf_counter()
                free_device_memory()
                held = torch.cuda.memory_allocated() if device.type == "cuda" else 0
                v1, l1, rec1 = run_path_t1(device, tier_name, data, sizes)
                v2, l2, rec2 = run_path_t2(device, tier_name, data, masks, sizes)
                recs = {**rec1, **rec2}
                if device.type == "cuda":  # the class_metrics compute's matcher again: replays on the graph tier
                    args = recs["mAP class_metrics"][0]["args"]
                    ops = device_profile(lambda: mean_ap.match_all_groups(*args), (), 1)[1]
                    base = _peak_start()
                    ms = time_ms(lambda: mean_ap.match_all_groups(*args), 3, warmup=1)
                    matcher = (f"at {recs['mAP class_metrics'][0]['shape']} {ms:.3f} ms of device time a call after the"
                               f" first (CUDA events), {ops:.0f} device operations, peak +{_peak_gib(base):.3f} GiB")
                    del args
                for calls in recs.values():
                    for r in (calls if isinstance(calls, list) else [calls]):
                        r.pop("args")
                free_device_memory()
                if device.type == "cuda":  # what the matcher keeps once its metrics are gone: one graph at most
                    held = (torch.cuda.memory_allocated() - held) / 2**30
                    kept = [key[0][0][0] for key, _ in mean_ap._MATCH_GRAPHS.values()]
                    if held > T_MATCH_HELD_GIB or len(kept) > 1:
                        raise AssertionError(f"path T: the matcher keeps {len(kept)} graphs ({kept}) and {held:.3f} GiB"
                                             f" after T1 and T2, allowed one and {T_MATCH_HELD_GIB} GiB")
                    matcher += (f"; after T1 and T2 {held:.3f} GiB held, graphs kept {len(kept)}"
                                f" (block {kept[0] if kept else None})")
                v3, l3, plain = run_path_t3(device, tier_name, sizes)
                for label, line in l1.items():
                    print(f"path T1 [{card}] {label}, {tier_name} tier: {line}")
                print(f"path T2 [{card}] bbox + segm, {tier_name} tier: {l2}")
                for label, line in l3.items():
                    print(f"path T3 [{card}] {label}, {tier_name} tier: {line}")
                if device.type == "cuda":
                    print(f"path T1 [{card}] matcher, {tier_name} tier: {matcher}")
                print(f"path T [{card}] {tier_name} tier: {time.perf_counter() - t_tier:.1f} s")
                flat = {name: (calls[0] if isinstance(calls, list) else calls) for name, calls in recs.items()}
                res[tier_name] = {"T1": _bits(v1), "T2": _bits(v2), "T3": _bits(v3),
                                  "tables": {k: hashlib.sha256(r["table"].tobytes()).hexdigest() for k, r in flat.items()}}
                if tier_name == "graph":
                    full, records, t3 = (v1, v2), flat, (v3, plain)
                del recs, flat
        same_on_both_tiers("path T", res["graph"], res["eager"])
        t_wait = time.perf_counter()
        oracles = {name: future.result() for name, future in futures.items()}
        (v1, v2), (v3, plain) = full, t3
        errors = {
            "T1 macro": check_t_map("path T1 class_metrics", v1["mAP class_metrics"], oracles["T1 macro"],
                                    records["mAP class_metrics"]),
            "T1 micro": check_t_map("path T1 micro", v1["mAP micro"], oracles["T1 micro"], records["mAP micro"]),
            "T2 bbox": check_t_map("path T2 bbox", v2, oracles["T2 bbox"], records["T2 bbox"], "bbox_"),
            "T2 segm": check_t_map("path T2 segm", v2, oracles["T2 segm"], records["T2 segm"], "segm_"),
        }
        for label, want in oracles["T1 IoU"].items():
            errors[f"T1 {label}"] = check_rel(f"path T1 {label}", v1[label], want, tol=0.0, bound=T_TOL)
        errors.update({f"T3 {k}": e for k, e in check_t3(device, v3, plain, sizes).items()})
        print(f"path T [{card}]: the oracles done {time.perf_counter() - t_wait:.1f} s after both tiers; match tables"
              f" equal to the plain greedy matcher's; worst error: " + ", ".join(f"{k} {e:.3g}" for k, e in errors.items()))
        print(f"path T [{card}]: map {float(v1['mAP class_metrics']['map']):.6f}, micro map"
              f" {float(v1['mAP micro']['map']):.6f}, segm map {float(v2['segm_map']):.6f}, PQ {float(v3['PQ']):.6f},"
              f" modified PQ {float(v3['modified PQ']):.6f}")
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    launches = {k: c.launches for k, c in kernel_counters().items()}
    if any(launches.values()):
        raise AssertionError(f"path T launched a kernel: {launches}")
    seconds = time.perf_counter() - started
    print(f"path T [{card}]: reduced: T2 over {n2} of T1's images (all 5,000 images' masks would hold about 150 GB);"
          f" T3's functionals over the first {sizes['t3_functional']} images at once (the whole set's int64 maps"
          f" would take 25 GB at once), the classes over all {sizes['t3_images']}")
    print(f"path T [{card}]: both tiers bit-equal, kernel launches {launches}; {seconds:.1f} s")
    return seconds


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

    # ---- path M: clustering and nominal association at full width (M1 the extrinsic scores, M2 the
    # intrinsic ones, M3 nominal association) on both tiers, every kernel's count set to 0 just before;
    # the numpy side is made first, and M1's inside its first tier
    started_m = time.perf_counter()
    m2_np = path_m2_data(M_SIZES["m2_rows"], M_SIZES["m2_dim"], M_SIZES["m2_clusters"])
    m2_want = intrinsic_np(*m2_np)
    m2_dev = tuple(torch.from_numpy(a).to(device) for a in m2_np)
    m3_refs = path_m3_refs()
    print(f"path M: M2's and M3's data and numpy side in {time.perf_counter() - started_m:.1f} s")
    for counter in LaunchCounter.ALL:
        counter.launches = 0
    res_m, refs_m1, launches_m = {}, None, {}
    for tier_name in ("graph", "eager"):
        with tier(tier_name):
            r = res_m[tier_name] = {}
            for part in ("M1", "M2", "M3"):
                before = k1.BINCOUNT.launches
                if part == "M1":
                    r[part], lines_m, refs_m1, _ = run_path_m1(device, tier_name, refs=refs_m1)
                elif part == "M2":
                    r[part], line, _ = run_path_m2(device, tier_name, m2_dev, m2_want, M_SIZES["m2_batch"])
                    lines_m = {"CH, DB, Dunn p=2 and p=1": line}
                else:
                    r[part], lines_m, _ = run_path_m3(device, tier_name, m3_refs)
                launches_m[(tier_name, part)] = k1.BINCOUNT.launches - before
                for label, line in lines_m.items():
                    print(f"path {part} [{card}] {label}, {tier_name} tier: {line}")
    same_on_both_tiers("path M", res_m["graph"], res_m["eager"])
    if min(launches_m.values()) == 0:
        raise AssertionError(f"path M: a part launched K1 no time: {launches_m}")
    if any(counter.launches for counter in LaunchCounter.ALL if counter is not k1.BINCOUNT):
        raise AssertionError(f"path M launched a kernel other than K1: {[c.launches for c in LaunchCounter.ALL]}")
    launches_m_graph = sum(v for (t, _), v in launches_m.items() if t == "graph")
    del m2_dev
    print(f"path M [{card}]: both tiers bit-equal; K1 launches {launches_m}; {time.perf_counter() - started_m:.1f} s")
    # K1 at path M's shapes: M1's contingency (the fused index of 50,000 relabelled pairs, 1000 x 1000
    # int32 bins) and M3's nominal confusion count (10,000 int32 code pairs, a bool drop mask, C = 1000)
    preds_m, target_m = (torch.from_numpy(a).to(device) for a in path_m1_labels(50_000, 1000, 31))
    fused_m = (target_m * 1000 + preds_m).contiguous()
    t_m1 = timing(
        "path M1 contingency shape (fused index, N=50,000 int64, 1,000,000 int32 bins)",
        lambda: k1.bincount(fused_m, 1_000_000), lambda: k1.bincount_plain(fused_m, 1_000_000),
        lambda: torch.bincount(fused_m, minlength=1_000_000), 50_000 * 8 + 1_000_000 * 4, 50_000, 500,
    )
    xm, ym = (torch.from_numpy(a).to(device) for a in path_m3_pairs(10_000, 1000))
    keep_m = ~(torch.isnan(xm) | torch.isnan(ym))
    pm, qm = torch.where(keep_m, xm, 0.0).to(torch.int32), torch.where(keep_m, ym, 0.0).to(torch.int32)
    fused_m3 = (qm.long() * 1000 + pm.long())[keep_m]
    t_m3 = timing(
        "path M3 nominal shape (confusion, N=10,000 int32 codes, bool drop mask, 1,000,000 int32 bins)",
        lambda: k1.confusion_counts(pm, qm, 1000, keep_m), lambda: k1.confusion_counts_plain(pm, qm, 1000, keep_m),
        lambda: torch.bincount(fused_m3, minlength=1_000_000), 10_000 * 9 + 1_000_000 * 4, 10_000, 500,
    )

    # ---- path N: the sketches, retrieval's sketch mode and the keyed engine on both tiers, every kernel's
    # count set to 0 just before the path
    launches_n_k1, launches_n_k2, n1_data, n3_data = run_path_n(device, card)
    # K1 at N1's count-min shape (the fused index of 100,000 ids over 4 rows into 4,096 bins), K2's sketch_update
    # at N3's keyed AUROC shape (its vmap rule: 8,192 one-sample labels of 2,048 bins) and hist_pair at the keyed
    # histogram's (8,192 indices into 1,000 x 64 bins)
    from torchmetrics_tpu_torch.sketch import countmin

    ids_n = torch.from_numpy(n1_data["ids"][0]).to(device)
    fused_n = countmin._fused(countmin._hash_rows(ids_n, N_CM_DEPTH, N_CM_WIDTH), N_CM_WIDTH)
    bins_n = N_CM_DEPTH * N_CM_WIDTH
    t_n1 = timing(
        f"path N1 count-min shape (fused index, N={fused_n.numel():,} int64, {bins_n:,} int32 bins)",
        lambda: k1.bincount(fused_n, bins_n), lambda: k1.bincount_plain(fused_n, bins_n),
        lambda: torch.bincount(fused_n, minlength=bins_n), fused_n.numel() * 8 + bins_n * 4, fused_n.numel(), 2000,
    )
    keys_n = N_SIZES["n3_batch"]
    scores_n = torch.from_numpy(n3_data["auroc"][1][:1]).to(device)
    clicks_n = torch.from_numpy(n3_data["auroc"][2][:1]).to(device)
    old_n = torch.zeros((keys_n, N_SIZES["n3_auroc_bins"]), device=device)  # the keyed update's rows start at the defaults
    # first the kernel against its plain version at this shape, exactly: the main path's zero rows, then rows of counts
    gen_n = np.random.RandomState(59)
    held_n = [torch.from_numpy(gen_n.randint(0, 50, old_n.shape).astype(np.float32)).to(device) for _ in range(2)]
    for old_pos, old_neg in ((old_n, old_n), held_n):
        for got, want in zip(k2.sketch_update(scores_n, clicks_n, old_pos, old_neg, "multilabel"),
                             k2.sketch_update_plain(scores_n, clicks_n, old_pos, old_neg, "multilabel")):
            if not torch.equal(got, want):
                raise AssertionError(f"K2 sketch_update at N3's vmap-rule shape differs from its plain version by up to"
                                     f" {float((got - want).abs().max())}")
    t_n3 = timing(
        f"path N3 keyed AUROC shape (sketch_update multilabel, the vmap rule's N=1 x {keys_n:,} labels,"
        f" {N_SIZES['n3_auroc_bins']} bins)",
        lambda: k2.sketch_update(scores_n, clicks_n, old_n, old_n, "multilabel"),
        lambda: k2.sketch_update_plain(scores_n, clicks_n, old_n, old_n, "multilabel"),
        None, keys_n * 8 + 4 * old_n.numel() * 4, keys_n, 200, tag="K2 sketch_update", library_name="library:",
        kernels=("sketch_update",),
    )
    hist_len = N_SIZES["n3_hist_keys"] * 64
    idx_h = (torch.from_numpy(n3_data["auroc"][3][0]).to(device).long() * 64
             + torch.clamp(torch.floor(scores_n[0] * 63), 0, 63).long())
    ones_h = torch.ones(idx_h.shape, device=device)
    for got, want in ((k2.hist_pair(idx_h, ones_h, None, hist_len), k2.hist_pair_plain(idx_h, ones_h, None, hist_len)),):
        if not torch.equal(got, want):
            raise AssertionError(f"K2 hist_pair at the keyed histogram's shape differs from its plain version by up to"
                                 f" {float((got - want).abs().max())}")
    t_n3h = timing(
        f"path N3 keyed StreamingHistogram shape (hist_pair, the vmap rule's N={idx_h.numel():,} int64, {hist_len:,} bins,"
        f" branch {k2.branch(hist_len, device)})",
        lambda: k2.hist_pair(idx_h, ones_h, None, hist_len), lambda: k2.hist_pair_plain(idx_h, ones_h, None, hist_len),
        lambda: torch.bincount(idx_h, weights=ones_h, minlength=hist_len), idx_h.numel() * 12 + 2 * hist_len * 4,
        idx_h.numel(), 2000, tag="K2", library_name="weighted torch.bincount", kernels=("pair_shared", "pair_global"),
    )

    # ---- path O: the online layer (windows, decay, drift alarms) and the engine's telemetry on both tiers,
    # every kernel's count set to 0 just before the path
    launches_o = run_path_o(device, card)

    # ---- path P: pairwise distances and the image-quality metrics at full width on both tiers and under a
    # caller's TF32 flags, every kernel's count set to 0 just before the path (none may launch)
    run_path_p(device, card)

    # ---- path Q: the generative image metrics (FID-50k, KID, IS, MiFID, LPIPS, PPL) and the audio domain
    # at full width on both tiers, every kernel's count set to 0 just before the path (none may launch)
    run_path_q(device, card)

    # ---- path R: text without a model (machine translation, speech recognition, QA and summarisation,
    # perplexity at GPT-2's width) on both tiers, every kernel's count set to 0 just before the path (none may launch)
    run_path_r(device, card)

    # ---- path S: the encoder-backed metrics (BERTScore, InfoLM, CLIPScore, CLIP-IQA) over seeded stand-in
    # encoders at roberta-large's, bert-base's and ViT-L/14's widths on both tiers, every kernel's count set to
    # 0 just before the path (none may launch)
    run_path_s(device, card)

    # ---- path T: detection (mean AP at COCO val2017's size, bbox and segm, the IoU family, panoptic quality) on
    # both tiers, every kernel's count set to 0 just before the path (none may launch)
    run_path_t(device, card)

    kernels = [{
        "name": "bincount", "route": "cuda", "source": "torchmetrics_tpu_torch/csrc/bincount.cu",
        "replaces": "torchmetrics_tpu/ops/pallas_hist.py:28",
        "launches": launches_a + launches_b + launches_e + launches_g + launches_i + launches_j + launches_l1 + launches_l2_k1
        + launches_l3 + launches_m_graph + launches_n_k1 + launches_o["K1"],
        "max_abs_err": max_err, **t_a, "binary_4_bins": t_e, "fairness_32_bins": t_j[10_000],
        "fairness_32_bins_1m": t_j[1_000_000], "clustering_contingency": t_m1, "nominal_confusion": t_m3,
        "countmin_update": t_n1,
    }, {
        "name": "curve_counts", "entry": "binned_confmat", "route": "cuda",
        "source": "torchmetrics_tpu_torch/csrc/curve_counts.cu", "replaces": "torchmetrics_tpu/ops/pallas_curve.py:44",
        "launches": launches_c + launches_f3 + launches_l2_k3 + launches_o["K3 binned_confmat"], "max_abs_err": 0.0,
        **t_k3["forward"],
    }, {
        "name": "hist_pair", "entry": "sketch_update", "route": "cuda", "source": "torchmetrics_tpu_torch/csrc/hist_pair.cu",
        "replaces": "torchmetrics_tpu/ops/pallas_hist.py:92", "launches": launches_d + launches_f2 + launches_l2_k2
        + launches_n_k2 + launches_o["K2 hist_pair"] + launches_o["K2 sketch_update"], "max_abs_err": errors["K2"], **t_sketch["path D binary shape"], "hist_pair": t_k2["path D binary shape"],
        "keyed_auroc_vmap_rule": t_n3, "keyed_hist_vmap_rule": t_n3h,
    }]
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s from start to the kernels line")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--sync-worker":  # one rank of path L2, started by run_path_l2
        sys.exit(l2_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4], json.loads(sys.argv[5]), sys.argv[6]))
    sys.exit(main())
