"""CLIPScore and CLIP-IQA (counterpart of ``torchmetrics_tpu/functional/multimodal/clip.py``).

The model is a pair of callables

    ``image_encoder(images) -> (N, d)``   and   ``text_encoder(list_of_strings) -> (M, d)``

or a HuggingFace CLIP id in the local cache, which ``utils/pretrained.clip_encoders`` resolves on the
entry's device (it raises the reference's ``ModuleNotFoundError`` otherwise). The similarity math
(normalise, cosine, the softmax over prompt pairs) runs on ``device``, CUDA unless named, in IEEE float32.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import resolve_device
from torchmetrics_tpu_torch.utils.precision import full_float32

EncoderPair = Tuple[Callable, Callable]

_PROMPTS: Dict[str, Tuple[str, str]] = {
    "quality": ("Good photo.", "Bad photo."),
    "brightness": ("Bright photo.", "Dark photo."),
    "noisiness": ("Clean photo.", "Noisy photo."),
    "colorfullness": ("Colorful photo.", "Dull photo."),
    "sharpness": ("Sharp photo.", "Blurry photo."),
    "contrast": ("High contrast photo.", "Low contrast photo."),
    "complexity": ("Complex photo.", "Simple photo."),
    "natural": ("Natural photo.", "Synthetic photo."),
    "happy": ("Happy photo.", "Sad photo."),
    "scary": ("Scary photo.", "Peaceful photo."),
    "new": ("New photo.", "Old photo."),
    "warm": ("Warm photo.", "Cold photo."),
    "real": ("Real photo.", "Abstract photo."),
    "beautiful": ("Beautiful photo.", "Ugly photo."),
    "lonely": ("Lonely photo.", "Sociable photo."),
    "relaxing": ("Relaxing photo.", "Stressful photo."),
}


def _resolve_encoders(model_name_or_path: Union[str, EncoderPair], rescale_uint8: bool = True,
                      device=None) -> EncoderPair:
    """The model argument as ``(image_encoder, text_encoder)`` (JAX ``clip.py:44``).

    ``rescale_uint8`` is the HF processor's /255 rescale: CLIPScore feeds raw [0, 255] images (True, the
    reference's contract); CLIP-IQA divides by ``data_range`` first, so its encoder must not rescale.
    """
    if isinstance(model_name_or_path, (tuple, list)) and len(model_name_or_path) == 2 and all(
        callable(f) for f in model_name_or_path
    ):
        return tuple(model_name_or_path)
    if not isinstance(model_name_or_path, str):
        raise ValueError(
            "Expected `model_name_or_path` to be a HuggingFace CLIP model id or a pair of callables"
            f" (image_encoder, text_encoder), got {model_name_or_path!r}"
        )
    from torchmetrics_tpu_torch.utils.pretrained import clip_encoders

    return clip_encoders(model_name_or_path, rescale_uint8=rescale_uint8, device=device)


def _features(x, device: torch.device) -> Tensor:
    """An encoder's output as a float32 tensor on ``device``."""
    t = x if isinstance(x, Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=torch.float32)


def _normalize(x: Tensor) -> Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def _ndim(x) -> int:
    return x.ndim if hasattr(x, "ndim") else np.ndim(x)


def _clip_score_update(
    images, text: Union[str, List[str]], image_encoder: Callable, text_encoder: Callable, device: torch.device,
) -> Tuple[Tensor, int]:
    """Per-sample 100·cos(image, caption) (JAX ``clip.py:70``)."""
    if not isinstance(images, list):
        images = [images] if _ndim(images) == 3 else list(images)
    if not all(_ndim(i) == 3 for i in images):
        raise ValueError('All images must be 3d, but found an image with a different number of dimensions')
    if not isinstance(text, list):
        text = [text]
    if len(text) != len(images):
        raise ValueError(
            f"Expected the number of images and text examples to be the same but got {len(images)} and {len(text)}"
        )
    img_features = _normalize(_features(image_encoder(images), device))
    txt_features = _normalize(_features(text_encoder(text), device))
    score = 100 * torch.sum(img_features * txt_features, dim=-1)
    return score, len(text)


def clip_score(
    images,
    text: Union[str, List[str]],
    model_name_or_path: Union[str, EncoderPair] = "openai/clip-vit-large-patch14",
    device=None,
) -> Tensor:
    """CLIPScore, max(100·cos(E_I, E_C), 0) averaged over the samples (JAX ``clip.py:92``), on ``device``."""
    dev = resolve_device(device)
    image_encoder, text_encoder = _resolve_encoders(model_name_or_path, device=dev)
    score, _ = _clip_score_update(images, text, image_encoder, text_encoder, dev)
    return torch.clamp(torch.mean(score), min=0.0)


def _clip_iqa_format_prompts(prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",)):
    """The prompt keywords and custom pairs expanded (JAX ``clip.py:103``)."""
    if not isinstance(prompts, tuple):
        raise ValueError("Argument `prompts` must be a tuple")
    prompts_names: List[str] = []
    prompts_list: List[str] = []
    count = 0
    for p in prompts:
        if not isinstance(p, (str, tuple)):
            raise ValueError("Argument `prompts` must be a tuple containing strings or nested tuples of strings")
        if isinstance(p, str):
            if p not in _PROMPTS:
                raise ValueError(
                    f"All elements of `prompts` must be one of {list(_PROMPTS.keys())} if not custom tuple"
                    f" prompts, got {p}."
                )
            prompts_names.append(p)
            prompts_list.extend(_PROMPTS[p])
        else:
            if len(p) != 2:
                raise ValueError("If a tuple is provided in argument `prompts`, it must be of length 2")
            prompts_names.append(f"user_defined_{count}")
            prompts_list.extend(p)
            count += 1
    return prompts_names, prompts_list


def _clip_iqa_compute(img_features: Tensor, anchors: Tensor, prompts_names: List[str], format_as_dict: bool = True):
    """The softmax over each (positive, negative) anchor pair (JAX ``clip.py:130``)."""
    with full_float32():
        logits_per_image = 100 * img_features @ anchors.T
    logits = logits_per_image.reshape(logits_per_image.shape[0], -1, 2)
    probs = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    probs = (probs / torch.sum(probs, dim=-1, keepdim=True))[:, :, 0]
    if len(prompts_names) == 1:
        return torch.squeeze(probs)
    if format_as_dict:
        return {p: probs[:, i] for i, p in enumerate(prompts_names)}
    return probs


def _check_iqa_model(model_name_or_path) -> None:
    if isinstance(model_name_or_path, str) and model_name_or_path == "clip_iqa":
        raise ModuleNotFoundError(
            "The 'clip_iqa' checkpoint (piq) is not bundled in this build; pass `model_name_or_path`"
            " as (image_encoder, text_encoder) callables or a cached HuggingFace CLIP id."
        )


def _check_data_range(data_range) -> None:
    if not (isinstance(data_range, (int, float)) and data_range > 0):
        raise ValueError('Argument `data_range` must be a positive number.')


def _iqa_images(images, data_range: float, device: torch.device) -> Tensor:
    """The batch as float32 on ``device``, divided by ``data_range`` before the encoder (JAX ``clip.py:167``)."""
    images = torch.as_tensor(images if isinstance(images, Tensor) else np.asarray(images)).to(device, torch.float32)
    if images.ndim != 4:
        raise ValueError(f"Expected `images` to be a batched 4d tensor (N, C, H, W), got shape {tuple(images.shape)}")
    return images / float(data_range)


def clip_image_quality_assessment(
    images,
    model_name_or_path: Union[str, EncoderPair] = "clip_iqa",
    data_range: float = 1.0,
    prompts: Tuple[Union[str, Tuple[str, str]], ...] = ("quality",),
    device=None,
):
    """CLIP-IQA (JAX ``clip.py:148``): the anchor-pair softmax probability per prompt, on ``device``."""
    prompts_names, prompts_list = _clip_iqa_format_prompts(prompts)
    _check_iqa_model(model_name_or_path)
    _check_data_range(data_range)
    dev = resolve_device(device)
    images = _iqa_images(images, data_range, dev)
    image_encoder, text_encoder = _resolve_encoders(model_name_or_path, rescale_uint8=False, device=dev)
    img_features = _normalize(_features(image_encoder(images), dev))
    anchors = _normalize(_features(text_encoder(prompts_list), dev))
    return _clip_iqa_compute(img_features, anchors, prompts_names)
