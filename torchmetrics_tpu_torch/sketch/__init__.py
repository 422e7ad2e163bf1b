"""Streaming sketch states of the PyTorch port (counterpart of ``torchmetrics_tpu.sketch``).

The port has the curve sketch: the threshold-histogram pair that the curve family
(``BinaryPrecisionRecallCurve`` and its subclasses) keeps under ``approx="sketch"``.
"""
from torchmetrics_tpu_torch.sketch.hist import (
    auroc_error_bound,
    hist_init,
    hist_threshold_counts,
    hist_update_classes,
    hist_update_pair,
    score_bucket,
    suffix_counts,
)
from torchmetrics_tpu_torch.sketch.state import (
    SketchSpec,
    hist_spec,
    register_sketch_state,
    sketch_descriptor,
    sketch_state_bytes,
)

__all__ = [
    "SketchSpec",
    "auroc_error_bound",
    "hist_init",
    "hist_spec",
    "hist_threshold_counts",
    "hist_update_classes",
    "hist_update_pair",
    "register_sketch_state",
    "score_bucket",
    "sketch_descriptor",
    "sketch_state_bytes",
    "suffix_counts",
]
