"""CLIPScore and CLIP-IQA module metrics (counterpart of ``torchmetrics_tpu/multimodal/clip.py``).

Both run the caller's encoders eagerly in their ``update`` (``jit_update = False``, as in JAX): the
encoders are user code. ``CLIPScore`` counts its samples in int64 where JAX counts in int32; a JAX
state loads through ``interop.load_numpy_state`` all the same.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch
from torch import Tensor

from torchmetrics_tpu_torch.functional.multimodal.clip import (
    EncoderPair,
    _check_data_range,
    _check_iqa_model,
    _clip_iqa_compute,
    _clip_iqa_format_prompts,
    _clip_score_update,
    _features,
    _iqa_images,
    _normalize,
    _resolve_encoders,
)
from torchmetrics_tpu_torch.metric import Metric


class CLIPScore(Metric):
    """CLIPScore (JAX ``multimodal/clip.py:20``): streaming sum and count states.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.multimodal import CLIPScore
        >>> table = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
        >>> image_encoder = lambda imgs: torch.stack([table[int(i.float().mean()) % 4] for i in imgs])
        >>> text_encoder = lambda text: torch.stack([table[len(t) % 4] for t in text])
        >>> metric = CLIPScore(model_name_or_path=(image_encoder, text_encoder), device="cpu")
        >>> metric.update([torch.full((3, 2, 2), 3)], ["a cat"])
        >>> print(f"{float(metric.compute()):.4f}")
        75.5304
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True  # forward() must route through the encoder-running update()
    plot_lower_bound = 0.0
    plot_upper_bound = 100.0
    jit_update = False

    def __init__(self, model_name_or_path: Union[str, EncoderPair] = "openai/clip-vit-large-patch14",
                 **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.image_encoder, self.text_encoder = _resolve_encoders(model_name_or_path, device=self.device)
        self.add_state("score", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("n_samples", torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, images, text) -> None:  # noqa: D102 - runs the encoders, then delegates
        score, n = _clip_score_update(images, text, self.image_encoder, self.text_encoder, self.device)
        super().update(torch.sum(score), n)

    def _update(self, state: Dict[str, Tensor], score_sum: Tensor, n: Tensor) -> Dict[str, Tensor]:
        return {"score": state["score"] + score_sum, "n_samples": state["n_samples"] + n}

    def _compute(self, state: Dict[str, Any]) -> Tensor:
        return torch.clamp(state["score"] / state["n_samples"], min=0.0)


class CLIPImageQualityAssessment(Metric):
    """CLIP-IQA (JAX ``multimodal/clip.py:62``): a ``cat`` list of per-image prompt probabilities.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.multimodal import CLIPImageQualityAssessment
        >>> table = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
        >>> image_encoder = lambda imgs: table[:1].expand(imgs.shape[0], 8)
        >>> text_encoder = lambda text: table[1:3]
        >>> metric = CLIPImageQualityAssessment(model_name_or_path=(image_encoder, text_encoder), device="cpu")
        >>> metric.update(torch.rand(2, 3, 4, 4))
        >>> metric.compute().shape
        torch.Size([2])
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound = 0.0
    plot_upper_bound = 1.0
    jit_update = False
    jit_compute = False

    def __init__(
        self,
        model_name_or_path: Union[str, EncoderPair] = "clip_iqa",
        data_range: float = 1.0,
        prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _check_data_range(data_range)
        self.data_range = data_range
        self.prompts_names, self.prompts_list = _clip_iqa_format_prompts(prompts)
        _check_iqa_model(model_name_or_path)
        self.image_encoder, self.text_encoder = _resolve_encoders(model_name_or_path, rescale_uint8=False,
                                                                  device=self.device)
        self._anchors = None
        self.add_state("probs_list", [], dist_reduce_fx="cat")

    def _anchor_vectors(self) -> Tensor:
        if self._anchors is None:
            self._anchors = _normalize(_features(self.text_encoder(self.prompts_list), self.device))
        return self._anchors

    def update(self, images) -> None:  # noqa: D102 - runs the encoders, then delegates
        images = _iqa_images(images, self.data_range, self.device)
        img_features = _normalize(_features(self.image_encoder(images), self.device))
        probs = _clip_iqa_compute(img_features, self._anchor_vectors(), self.prompts_names, format_as_dict=False)
        super().update(torch.atleast_2d(probs.reshape(images.shape[0], -1)))

    def _update(self, state: Dict[str, Tensor], probs: Tensor) -> Dict[str, Tensor]:
        return {"probs_list": probs}

    def _compute(self, state: Dict[str, Any]):
        probs = state["probs_list"]
        if isinstance(probs, list):
            raise RuntimeError("No images accumulated; call `update` before `compute`.")
        if len(self.prompts_names) == 1:
            return torch.squeeze(probs)
        return {p: probs[:, i] for i, p in enumerate(self.prompts_names)}
