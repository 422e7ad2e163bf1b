"""Device operations of the PyTorch port (counterpart of ``torchmetrics_tpu/ops``).

``ops.histogram`` holds the counting entries; ``ops.bincount`` is kernel K1 with its plain version. The JAX
package's ``ops.__all__`` names nine entries; eight are re-exported here under their names. ``bincount`` is not:
``ops.bincount`` stays the K1 module, a difference kept on purpose (ROADMAP.md, queue C), and the counting entry
is ``ops.histogram.bincount``.
"""
from torchmetrics_tpu_torch.ops.histogram import bincount_weighted, confusion_matrix_update
from torchmetrics_tpu_torch.ops.segments import (
    segment_count,
    segment_max,
    segment_mean,
    segment_mean_pair,
    segment_min,
    segment_sum,
)

__all__ = [
    "bincount_weighted",
    "confusion_matrix_update",
    "segment_sum",
    "segment_count",
    "segment_mean",
    "segment_mean_pair",
    "segment_max",
    "segment_min",
]
