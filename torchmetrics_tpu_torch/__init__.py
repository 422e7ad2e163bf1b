"""PyTorch and CUDA port of ``torchmetrics_tpu``, for NVIDIA Hopper (H100).

The port is a package of its own beside the JAX package, which stays the reference. It imports
``torch`` and numpy, never ``jax`` and nothing of ``torchmetrics_tpu``. Metrics run on CUDA
unless the caller passes ``device="cpu"``; the TPU's Pallas kernels become hand-written CUDA
kernels under ``csrc/``, built with ``nvcc`` at first use.

Ported so far: ``Metric`` and ``MetricCollection`` with compute groups; the stat-scores family
(stat scores, accuracy, precision, recall, F-beta) and confusion matrices of every task; the curve
family (precision-recall curve, ROC, AUROC, average precision) with its fixed-point metrics, in
exact, binned and sketched states; calibration error; the aggregation metrics; the retrieval
metrics (``retrieval/``, the flat segment-reduce engine); operator composition
(``CompositionalMetric``) and ``set_dtype``; and the engine's fused tiers (``update_batches``,
``sweep_fn``, ``buffered``, the fused forward, the retrieval compute), which run each step as one
captured CUDA graph on the card (``ops/dispatch.py``). ``ROADMAP.md`` lists what is still to port.
"""
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.metric import CompositionalMetric, Metric
from torchmetrics_tpu_torch.retrieval import (
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalPrecisionRecallCurve,
    RetrievalRecall,
    RetrievalRecallAtFixedPrecision,
    RetrievalRPrecision,
)

__version__ = "0.1.0"

__all__ = [
    "CompositionalMetric",
    "Metric",
    "MetricCollection",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
    "RetrievalRPrecision",
]
