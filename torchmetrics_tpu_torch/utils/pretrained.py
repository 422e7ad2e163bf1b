"""Adapters for the pretrained models behind FID/KID/IS/MiFID, LPIPS, CLIP and BERT (counterpart of
``torchmetrics_tpu/utils/pretrained.py``).

The reference ships working defaults for its model-based metrics: torch-fidelity's InceptionV3, the
pretrained LPIPS nets, a HuggingFace CLIP and a default BERT. Each adapter here resolves that default
through whatever stack is installed (torch-fidelity, torchvision with ``lpips``, transformers with
locally cached weights), puts the model on the ``device`` it is given and returns a callable from
``torch.Tensor`` to ``torch.Tensor`` on that device. Where the stack is absent it raises the JAX
package's ``ModuleNotFoundError`` text word for word, which is the reference's. The JAX package's
adapters copy to numpy and back to ``jnp``; these hand the tensors through.

Nothing here downloads unless a local snapshot is missing and the hub resolves
(``_from_pretrained``); ``bert_encoder`` and ``torch_bert_encoder`` feed the text models the
tokenizer's batch on the model's device.
"""
from __future__ import annotations

import importlib.util
import os
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

Device = Union[str, torch.device, None]


def _package_available(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


_TORCH_AVAILABLE = _package_available("torch")
_TORCH_FIDELITY_AVAILABLE = _package_available("torch_fidelity")
_TORCHVISION_AVAILABLE = _package_available("torchvision")
_LPIPS_AVAILABLE = _package_available("lpips")
_TRANSFORMERS_AVAILABLE = _package_available("transformers")


def hf_model_cached(model_id: str) -> bool:
    """True if ``model_id`` has a snapshot in the local HuggingFace cache (no network touch)."""
    if not _TRANSFORMERS_AVAILABLE:
        return False
    try:
        from huggingface_hub import constants

        cache_dir = constants.HF_HUB_CACHE
    except (ImportError, AttributeError):
        cache_dir = os.path.expanduser("~/.cache/huggingface/hub")
    folder = os.path.join(cache_dir, "models--" + model_id.replace("/", "--"))
    snapshots = os.path.join(folder, "snapshots")
    return os.path.isdir(snapshots) and bool(os.listdir(snapshots))


def host_reachable(host: str, port: int = 443) -> bool:
    """One DNS resolution: a machine without egress fails it at once, before a download client's
    retries."""
    import socket

    try:
        socket.getaddrinfo(host, port)
        return True
    except OSError:
        return False


def _hub_reachable() -> bool:
    return host_reachable("huggingface.co")


def _from_pretrained(cls: Any, model_id: str, **kwargs: Any) -> Any:
    """Cache-first ``from_pretrained``: the local snapshot, then the network only where the hub
    resolves (the reference's behaviour), so a machine without egress fails at once."""
    try:
        return cls.from_pretrained(model_id, local_files_only=True, **kwargs)
    except Exception:  # noqa: BLE001 - any loading failure falls through to the network or re-raises
        if not _hub_reachable():
            raise
        return cls.from_pretrained(model_id, **kwargs)


def _device(device: Device) -> torch.device:
    from torchmetrics_tpu_torch.metric import resolve_device

    return resolve_device(device)


def _module_device(model: Any) -> torch.device:
    """Where a user's module keeps its parameters (the CPU for one without any)."""
    try:
        return next(model.parameters()).device
    except (AttributeError, StopIteration, TypeError):
        return torch.device("cpu")


# ---------------------------------------------------------------------------
# InceptionV3 features for FID / KID / IS / MiFID
# ---------------------------------------------------------------------------

def inception_feature_extractor(feature: Any, metric_display: str, device: Device = None) -> Callable[[Tensor], Tensor]:
    """Resolve the reference's integer or string ``feature`` to torch-fidelity's InceptionV3 on ``device``.

    ``feature`` in {64, 192, 768, 2048} selects the block, ``"logits_unbiased"`` the IS logits head.
    Raises the reference's ``ModuleNotFoundError`` when torch-fidelity is not installed.
    """
    if not (_TORCH_AVAILABLE and _TORCH_FIDELITY_AVAILABLE):
        raise ModuleNotFoundError(
            f"{metric_display} metric requires that `Torch-fidelity` is installed."
            " Either install as `pip install torchmetrics[image]` or `pip install torch-fidelity`."
        )
    from torch_fidelity.feature_extractor_inceptionv3 import FeatureExtractorInceptionV3

    dev = _device(device)
    net = FeatureExtractorInceptionV3(name="inception-v3-compat", features_list=[str(feature)]).to(dev)
    net.eval()

    def extract(imgs: Tensor) -> Tensor:
        x = torch.as_tensor(imgs, device=dev)
        if x.ndim == 3:
            x = x.unsqueeze(0)
        if x.dtype != torch.uint8:
            # torch-fidelity's input contract, checked here instead of truncating floats
            raise ValueError(
                "The InceptionV3 extractor expects uint8 images in [0, 255]; got dtype"
                f" {x.dtype}. Pass `normalize=True` for [0, 1] float inputs."
            )
        with torch.no_grad():
            (out,) = net(x)
        return out

    return extract


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

def lpips_network(net_type: str, device: Device = None) -> Callable[[Tensor, Tensor], Tensor]:
    """Pretrained LPIPS distance on ``device`` as a callable ``(img1, img2) -> (N,)``.

    Raises the reference's error when torchvision is absent, and the JAX package's when the ``lpips``
    package, which holds the learned weights, is.
    """
    if not (_TORCH_AVAILABLE and _TORCHVISION_AVAILABLE):
        raise ModuleNotFoundError(
            "LPIPS metric requires that torchvision is installed."
            " Either install as `pip install torchmetrics[image]` or `pip install torchvision`."
        )
    if not _LPIPS_AVAILABLE:  # torchvision's backbones without the learned weights are not the metric
        raise ModuleNotFoundError(
            "LPIPS metric requires the `lpips` package for its learned weights."
            " Install it with `pip install lpips`."
        )
    import lpips as _lpips

    dev = _device(device)
    net = _lpips.LPIPS(net=net_type, verbose=False).to(dev)
    net.eval()

    def distance(img1: Tensor, img2: Tensor) -> Tensor:
        t1 = torch.as_tensor(img1, dtype=torch.float32, device=dev)
        t2 = torch.as_tensor(img2, dtype=torch.float32, device=dev)
        with torch.no_grad():
            out = net(t1, t2, normalize=False)
        return out.reshape(-1)

    return distance


# ---------------------------------------------------------------------------
# CLIP (CLIPScore / CLIP-IQA)
# ---------------------------------------------------------------------------

def clip_encoders(
    model_id: str, rescale_uint8: bool = True, device: Device = None
) -> Tuple[Callable[[Any], Tensor], Callable[[List[str]], Tensor]]:
    """(image_encoder, text_encoder) over a HuggingFace CLIP checkpoint on ``device``.

    Raises the reference's error when transformers is absent, and a ``ModuleNotFoundError`` naming the
    checkpoint when transformers is present but the checkpoint cannot be loaded (no cache, no egress).
    """
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`clip_score` metric requires `transformers` package be installed."
            " Either install with `pip install transformers>=4.10.0` or `pip install torchmetrics[multimodal]`."
        )
    try:
        from transformers import CLIPModel, CLIPProcessor

        model = _from_pretrained(CLIPModel, model_id)
        processor = _from_pretrained(CLIPProcessor, model_id)
        model.eval()
    except Exception as err:  # noqa: BLE001 - every loading failure gets the one message
        raise ModuleNotFoundError(
            f"Loading CLIP checkpoint {model_id!r} failed (no local cache and no network egress"
            " in this build). Pass `model_name_or_path` as a pair of callables"
            " (image_encoder, text_encoder) instead."
        ) from err
    dev = _device(device)
    model = model.to(dev)

    def image_encoder(images: Any) -> Tensor:
        imgs = [torch.as_tensor(i).cpu() for i in images]
        with torch.no_grad():
            inp = processor(images=imgs, return_tensors="pt", padding=True, do_rescale=rescale_uint8)
            return model.get_image_features(inp["pixel_values"].to(dev))

    def text_encoder(text: List[str]) -> Tensor:
        with torch.no_grad():
            inp = processor(text=list(text), return_tensors="pt", padding=True)
            max_pos = model.config.text_config.max_position_embeddings
            return model.get_text_features(inp["input_ids"][..., :max_pos].to(dev),
                                           inp["attention_mask"][..., :max_pos].to(dev))

    return image_encoder, text_encoder


# ---------------------------------------------------------------------------
# BERT (BERTScore / InfoLM)
# ---------------------------------------------------------------------------

def _special_free_mask(attention_mask: Tensor) -> Tensor:
    """The attention mask with the [CLS] position and the last attended ([SEP]) position zeroed."""
    mask = attention_mask.clone()
    mask[:, 0] = 0
    sep_pos = torch.cumsum(mask - 0.1, dim=-1).argmax(-1)
    mask[torch.arange(mask.size(0)), sep_pos] = 0
    return mask


def torch_bert_encoder(
    model: Any,
    tokenizer: Any,
    forward_fn: Optional[Callable] = None,
    num_layers: Optional[int] = None,
    max_length: int = 512,
    all_layers: bool = False,
    device: Device = None,
):
    """Encoder over a user's torch model and HF-style tokenizer (the reference's ``own_model`` path).

    ``forward_fn(model, batch_dict) -> (N, L, D)`` overrides the default
    ``model(input_ids, attention_mask, output_hidden_states=True)`` call. The batch goes to the
    model's own device, which this adapter leaves as it is; the hidden states and the mask with the
    [CLS]/[SEP] positions zeroed come back on ``device``. ``tokenize`` returns numpy, as JAX's does.
    """
    dev = _device(device)

    def _batch(sentences: List[str]):
        return tokenizer(sentences, return_tensors="pt", padding=True, truncation=True, max_length=max_length)

    def encoder(sentences: List[str]):
        batch = _batch(sentences)
        on_model = _module_device(model)
        ids, attention = batch["input_ids"].to(on_model), batch["attention_mask"].to(on_model)
        with torch.no_grad():
            if all_layers:
                out = model(ids, attention, output_hidden_states=True)
                hidden = torch.stack(out.hidden_states, dim=1)  # (N, layers, L, D)
            elif forward_fn is not None:
                hidden = forward_fn(model, {k: v.to(on_model) for k, v in batch.items()})
            else:
                out = model(ids, attention, output_hidden_states=True)
                hidden = out.hidden_states[num_layers if num_layers is not None else -1]
        return hidden.to(dev), _special_free_mask(batch["attention_mask"]).to(dev)

    def tokenize(sentences: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        batch = _batch(sentences)
        mask = _special_free_mask(batch["attention_mask"])
        return np.asarray(batch["input_ids"].numpy(), np.int64), np.asarray(mask.numpy())

    # an all_layers encoder returns the (N, layers, L, D) stack: bert_score's all_layers check reads this
    encoder.layer_stacked = bool(all_layers)
    return encoder, tokenize


def hf_bert_model_and_tokenizer(
    model_id: str, load_model: bool = True, load_tokenizer: bool = True, device: Device = None
) -> Tuple[Any, Any]:
    """Raw (model, tokenizer) over a cached HF checkpoint, the model on ``device``; only the requested
    pieces are loaded, the other slot of the pair is ``None``."""
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`bert_score` metric requires `transformers` package be installed."
            " Either install with `pip install transformers` or `pip install torchmetrics[text]`."
        )
    try:
        from transformers import AutoModel, AutoTokenizer

        tokenizer = _from_pretrained(AutoTokenizer, model_id) if load_tokenizer else None
        model = _from_pretrained(AutoModel, model_id) if load_model else None
    except Exception as err:  # noqa: BLE001 - every loading failure gets the one message
        raise ModuleNotFoundError(
            f"Loading checkpoint {model_id!r} failed (no local cache and no network egress"
            " in this build). Pass an `encoder` callable `(sentences) -> (embeddings, mask)` instead."
        ) from err
    if model is not None:
        model = model.to(_device(device))
        model.eval()
    return model, tokenizer


def bert_encoder(
    model_id: str, num_layers: Optional[int] = None, max_length: int = 512,
    all_layers: bool = False, device: Device = None,
):
    """``(encoder, tokenize)`` over a cached HF model on ``device``: ``encoder(sentences) -> (hidden
    (N, L, D), mask (N, L))`` with the special tokens masked, ``tokenize(sentences) -> (ids (N, L)
    np.int64, mask (N, L))`` for idf weighting."""
    if not _TRANSFORMERS_AVAILABLE:
        raise ModuleNotFoundError(
            "`bert_score` metric requires `transformers` package be installed."
            " Either install with `pip install transformers` or `pip install torchmetrics[text]`."
        )
    try:
        from transformers import AutoModel, AutoTokenizer

        tokenizer = _from_pretrained(AutoTokenizer, model_id)
        model = _from_pretrained(AutoModel, model_id)
        model.eval()
    except Exception as err:  # noqa: BLE001 - every loading failure gets the one message
        raise ModuleNotFoundError(
            f"Loading checkpoint {model_id!r} failed (no local cache and no network egress"
            " in this build). Pass an `encoder` callable `(sentences) -> (embeddings, mask)` instead."
        ) from err
    dev = _device(device)
    model = model.to(dev)

    def tokenize(sentences: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        batch = tokenizer(
            sentences, return_tensors="np", padding=True, truncation=True, max_length=max_length,
            return_special_tokens_mask=True,
        )
        mask = batch["attention_mask"] * (1 - batch["special_tokens_mask"])
        return np.asarray(batch["input_ids"], np.int64), np.asarray(mask)

    def encoder(sentences: List[str]):
        batch = tokenizer(
            sentences, return_tensors="pt", padding=True, truncation=True, max_length=max_length,
            return_special_tokens_mask=True,
        )
        special = batch.pop("special_tokens_mask")
        with torch.no_grad():
            out = model(**{k: v.to(dev) for k, v in batch.items()}, output_hidden_states=True)
            if all_layers:
                hidden = torch.stack(out.hidden_states, dim=1)  # (N, layers, L, D)
            else:
                hidden = out.hidden_states[num_layers if num_layers is not None else -1]
        return hidden, (batch["attention_mask"] * (1 - special)).to(dev)

    encoder.layer_stacked = bool(all_layers)
    return encoder, tokenize
