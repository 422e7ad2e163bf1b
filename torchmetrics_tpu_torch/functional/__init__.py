"""Functional metrics of the PyTorch port (counterpart of ``torchmetrics_tpu.functional``).

As in the JAX package (``functional/__init__.py:116-142``), the clustering entries are attributes of
this module but not in its ``__all__``; the nominal ones are in both. The pairwise entries are in
both; of the image entries, ``peak_signal_noise_ratio_with_blocked_effect`` and
``visual_information_fidelity`` are attributes only, as there (``:177-191``, ``:243-330``). All 11 audio
entries are attributes; six of them are in ``__all__``, as there (``:193-205``). Of the text entries,
the 13 of JAX's ``__all__`` are in both and ``edit_distance`` is an attribute only (``:143-155``, ``:216-218``);
the text entries that take strings take a ``device`` keyword. ``bert_score`` and ``infolm`` are attributes
only, as there (``:224-225``); of the detection entries, ``panoptic_quality`` is in both and the other five are
attributes only (``:207-215``); the two multimodal entries are attributes only (``:219-223``).
"""
from torchmetrics_tpu_torch.functional import audio  # noqa: F401
from torchmetrics_tpu_torch.functional import classification as _classification
from torchmetrics_tpu_torch.functional import clustering  # noqa: F401
from torchmetrics_tpu_torch.functional import detection  # noqa: F401
from torchmetrics_tpu_torch.functional import image  # noqa: F401
from torchmetrics_tpu_torch.functional import multimodal  # noqa: F401
from torchmetrics_tpu_torch.functional import nominal
from torchmetrics_tpu_torch.functional import pairwise
from torchmetrics_tpu_torch.functional import regression as _regression
from torchmetrics_tpu_torch.functional import retrieval as _retrieval
from torchmetrics_tpu_torch.functional import text  # noqa: F401
from torchmetrics_tpu_torch.functional.audio import (  # noqa: F401
    complex_scale_invariant_signal_noise_ratio,
    perceptual_evaluation_speech_quality,
    permutation_invariant_training,
    pit_permutate,
    scale_invariant_signal_distortion_ratio,
    scale_invariant_signal_noise_ratio,
    short_time_objective_intelligibility,
    signal_distortion_ratio,
    signal_noise_ratio,
    source_aggregated_signal_distortion_ratio,
    speech_reverberation_modulation_energy_ratio,
)
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
from torchmetrics_tpu_torch.functional.detection import (  # noqa: F401
    complete_intersection_over_union,
    distance_intersection_over_union,
    generalized_intersection_over_union,
    intersection_over_union,
    modified_panoptic_quality,
    panoptic_quality,
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
from torchmetrics_tpu_torch.functional.multimodal import clip_image_quality_assessment, clip_score  # noqa: F401
from torchmetrics_tpu_torch.functional.nominal import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.text import (  # noqa: F401
    bleu_score,
    char_error_rate,
    chrf_score,
    edit_distance,
    match_error_rate,
    perplexity,
    sacre_bleu_score,
    squad,
    word_error_rate,
    word_information_lost,
    word_information_preserved,
)
from torchmetrics_tpu_torch.functional.text.bert import bert_score  # noqa: F401
from torchmetrics_tpu_torch.functional.text.eed import extended_edit_distance  # noqa: F401
from torchmetrics_tpu_torch.functional.text.infolm import infolm  # noqa: F401
from torchmetrics_tpu_torch.functional.text.rouge import rouge_score  # noqa: F401
from torchmetrics_tpu_torch.functional.text.ter import translation_edit_rate  # noqa: F401
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

#: the audio entries of the JAX package's ``functional.__all__``
_AUDIO_ALL = [
    "permutation_invariant_training",
    "pit_permutate",
    "scale_invariant_signal_distortion_ratio",
    "scale_invariant_signal_noise_ratio",
    "signal_distortion_ratio",
    "signal_noise_ratio",
]

#: the text entries of the JAX package's ``functional.__all__``
_TEXT_ALL = [
    "bleu_score",
    "char_error_rate",
    "chrf_score",
    "extended_edit_distance",
    "match_error_rate",
    "perplexity",
    "rouge_score",
    "sacre_bleu_score",
    "squad",
    "translation_edit_rate",
    "word_error_rate",
    "word_information_lost",
    "word_information_preserved",
]

__all__ = (_classification.__all__ + nominal.__all__ + _regression.__all__ + _retrieval.__all__ + pairwise.__all__
           + _IMAGE_ALL + _AUDIO_ALL + _TEXT_ALL + ["panoptic_quality"])
