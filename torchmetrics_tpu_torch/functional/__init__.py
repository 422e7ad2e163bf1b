"""Functional metrics of the PyTorch port (counterpart of ``torchmetrics_tpu.functional``).

As in the JAX package (``functional/__init__.py:116-142``), the clustering entries are attributes of
this module but not in its ``__all__``; the nominal ones are in both. The pairwise entries are in
both; of the image entries, ``peak_signal_noise_ratio_with_blocked_effect`` and
``visual_information_fidelity`` are attributes only, as there (``:177-191``, ``:243-330``).
"""
from torchmetrics_tpu_torch.functional import classification as _classification
from torchmetrics_tpu_torch.functional import clustering  # noqa: F401
from torchmetrics_tpu_torch.functional import image  # noqa: F401
from torchmetrics_tpu_torch.functional import nominal
from torchmetrics_tpu_torch.functional import pairwise
from torchmetrics_tpu_torch.functional import regression as _regression
from torchmetrics_tpu_torch.functional import retrieval as _retrieval
from torchmetrics_tpu_torch.functional.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.clustering import (  # noqa: F401
    adjusted_mutual_info_score,
    adjusted_rand_score,
    calinski_harabasz_score,
    completeness_score,
    davies_bouldin_score,
    dunn_index,
    fowlkes_mallows_index,
    homogeneity_score,
    mutual_info_score,
    normalized_mutual_info_score,
    rand_score,
    v_measure_score,
)
from torchmetrics_tpu_torch.functional.image import (  # noqa: F401
    error_relative_global_dimensionless_synthesis,
    image_gradients,
    multiscale_structural_similarity_index_measure,
    peak_signal_noise_ratio,
    peak_signal_noise_ratio_with_blocked_effect,
    relative_average_spectral_error,
    root_mean_squared_error_using_sliding_window,
    spectral_angle_mapper,
    spectral_distortion_index,
    structural_similarity_index_measure,
    total_variation,
    universal_image_quality_index,
    visual_information_fidelity,
)
from torchmetrics_tpu_torch.functional.nominal import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.pairwise import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.regression import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.retrieval import *  # noqa: F401,F403

#: the image entries of the JAX package's ``functional.__all__``
_IMAGE_ALL = [
    "error_relative_global_dimensionless_synthesis",
    "image_gradients",
    "multiscale_structural_similarity_index_measure",
    "peak_signal_noise_ratio",
    "relative_average_spectral_error",
    "root_mean_squared_error_using_sliding_window",
    "spectral_angle_mapper",
    "spectral_distortion_index",
    "structural_similarity_index_measure",
    "total_variation",
    "universal_image_quality_index",
]

__all__ = (_classification.__all__ + nominal.__all__ + _regression.__all__ + _retrieval.__all__ + pairwise.__all__
           + _IMAGE_ALL)
