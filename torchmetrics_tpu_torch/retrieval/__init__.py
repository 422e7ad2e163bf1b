"""Retrieval metrics of the PyTorch port (counterpart of ``torchmetrics_tpu.retrieval``)."""
from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric
from torchmetrics_tpu_torch.retrieval.metrics import (
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

__all__ = [
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalMetric",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
    "RetrievalRPrecision",
]
