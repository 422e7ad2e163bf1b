"""Functional clustering scores (counterpart of ``torchmetrics_tpu/functional/clustering/__init__.py``).

Each entry takes tensors and returns a float32 tensor on their device. Labels may be any real,
integral values (gapped, negative or float); they are relabelled on the device.
"""
from torchmetrics_tpu_torch.functional.clustering.extrinsic import (
    adjusted_mutual_info_score,
    adjusted_rand_score,
    completeness_score,
    expected_mutual_info_score,
    fowlkes_mallows_index,
    homogeneity_score,
    mutual_info_score,
    normalized_mutual_info_score,
    rand_score,
    v_measure_score,
)
from torchmetrics_tpu_torch.functional.clustering.intrinsic import (
    calinski_harabasz_score,
    davies_bouldin_score,
    dunn_index,
)

__all__ = [
    "adjusted_mutual_info_score",
    "adjusted_rand_score",
    "calinski_harabasz_score",
    "completeness_score",
    "davies_bouldin_score",
    "dunn_index",
    "expected_mutual_info_score",
    "fowlkes_mallows_index",
    "homogeneity_score",
    "mutual_info_score",
    "normalized_mutual_info_score",
    "rand_score",
    "v_measure_score",
]
