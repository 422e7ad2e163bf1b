"""Streaming sketch states of the PyTorch port (counterpart of ``torchmetrics_tpu.sketch``).

Fixed-shape, mergeable states registered through ``add_state``: the KLL compactor's quantiles, the
count-min sketch's id counts, and the threshold-histogram pair that the curve family keeps under
``approx="sketch"``; and the two metrics built on them, ``StreamingQuantile`` and
``StreamingHistogram``. Retrieval's ``approx="sketch"`` mode counts its query ids with count-min.
"""
from torchmetrics_tpu_torch.sketch.countmin import cm_error_bound, cm_init, cm_query, cm_update
from torchmetrics_tpu_torch.sketch.hist import (
    auroc_error_bound,
    hist_init,
    hist_threshold_counts,
    hist_update_classes,
    hist_update_pair,
    score_bucket,
    suffix_counts,
)
from torchmetrics_tpu_torch.sketch.kll import (
    kll_cdf,
    kll_count,
    kll_init,
    kll_merge,
    kll_merge_stacked,
    kll_quantiles,
    kll_update,
)
from torchmetrics_tpu_torch.sketch.metrics import StreamingHistogram, StreamingQuantile
from torchmetrics_tpu_torch.sketch.state import (
    SKETCH_EQUIVALENTS,
    SketchSpec,
    countmin_spec,
    hist_spec,
    kll_spec,
    note_update,
    register_sketch_state,
    sketch_descriptor,
    sketch_state_bytes,
    sketch_wire_bytes,
    sketch_wire_kinds,
)

__all__ = [
    "SKETCH_EQUIVALENTS",
    "SketchSpec",
    "StreamingHistogram",
    "StreamingQuantile",
    "auroc_error_bound",
    "cm_error_bound",
    "cm_init",
    "cm_query",
    "cm_update",
    "countmin_spec",
    "hist_init",
    "hist_spec",
    "hist_threshold_counts",
    "hist_update_classes",
    "hist_update_pair",
    "kll_cdf",
    "kll_count",
    "kll_init",
    "kll_merge",
    "kll_merge_stacked",
    "kll_quantiles",
    "kll_spec",
    "kll_update",
    "note_update",
    "register_sketch_state",
    "score_bucket",
    "sketch_descriptor",
    "sketch_state_bytes",
    "sketch_wire_bytes",
    "sketch_wire_kinds",
    "suffix_counts",
]
