"""BERTScore (counterpart of ``torchmetrics_tpu/functional/text/bert.py``).

The model is the caller's: a callable

    ``encoder(sentences: List[str]) -> (embeddings (N, L, D), mask (N, L))``

where ``mask`` is 1 for real (non-special) token positions, or the reference's ``own_model`` /
``user_tokenizer`` / ``user_forward_fn`` hooks, or a HuggingFace model id resolved from the local cache
(``utils/pretrained.py``). Tokenisation, the IDF table and the baseline file stay on the host, as in
JAX; the greedy cosine matching, the metric itself, runs on ``device`` (CUDA unless named) as one
batched product in IEEE float32 (``utils/precision.full_float32``), whatever TF32 flags the caller set.
"""
from __future__ import annotations

import csv
import math
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from torchmetrics_tpu_torch.metric import resolve_device
from torchmetrics_tpu_torch.utils.precision import full_float32
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

Encoder = Callable[[List[str]], Tuple[Tensor, Tensor]]
Tokenize = Callable[[List[str]], Tuple[np.ndarray, np.ndarray]]

_DEFAULT_MODEL = "roberta-large"
#: the reference's knobs that change nothing here (batching and progress of its own loop)
_INERT = frozenset({"verbose", "batch_size", "num_threads"})
_SUPPORTED = frozenset({"all_layers", "user_forward_fn", "user_tokenizer", "own_model", "return_hash"})


def _tokens_idf(ids: np.ndarray, mask: np.ndarray) -> Dict[int, float]:
    """Inverse document frequencies over the reference corpus (JAX ``bert.py:38``):
    idf(t) = log((N+1)/(df(t)+1)), with log(N+1) for unseen tokens; masked positions are ignored."""
    n_sentences = ids.shape[0]
    df: Counter = Counter()
    for row, m in zip(ids, mask):
        df.update(set(row[m > 0].tolist()))
    default = math.log(n_sentences + 1)
    idf = {tok: math.log((n_sentences + 1) / (occ + 1)) for tok, occ in df.items()}
    return {"__default__": default, **idf}


def _idf_weights(ids: np.ndarray, idf: Dict[int, float]) -> np.ndarray:
    default = idf["__default__"]
    return np.vectorize(lambda t: idf.get(int(t), default), otypes=[np.float32])(ids)


def _load_baseline_file(path: str) -> np.ndarray:
    """Parse a bert-score baseline csv/tsv (JAX ``bert.py:57``): a header row, then ``layer,P,R,F``
    rows. Returns a (num_layers+1, 3) float32 array."""
    with open(path, newline="") as f:
        sample = f.read(4096)
        f.seek(0)
        dialect = csv.Sniffer().sniff(sample, delimiters=",\t")
        rows = [[float(x) for x in row] for idx, row in enumerate(csv.reader(f, dialect)) if idx > 0 and row]
    return np.asarray(rows, np.float32)[:, 1:]


def _as_tensor(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> Tensor:
    """An encoder's output (a tensor anywhere, or numpy) as a tensor on ``device``."""
    t = x if isinstance(x, Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=dtype if dtype is not None else t.dtype)


def _bert_score_from_embeddings(
    preds_emb: Tensor, preds_mask: Tensor, target_emb: Tensor, target_mask: Tensor,
    preds_weights: Optional[Tensor] = None, target_weights: Optional[Tensor] = None,
) -> Dict[str, Tensor]:
    """Greedy-matched precision, recall and F1 (JAX ``bert.py:72``).

    The embeddings are ``(N, L, D)``, or ``(Λ, N, L, D)`` for every layer at once: the layer axis is
    folded into the batch of one ``bmm``, and the scores come back ``(Λ, N)``. The masks and weights
    are ``(N, L)``, shared by every layer. Weights default to uniform over real tokens.
    """
    layers = preds_emb.shape[0] if preds_emb.ndim == 4 else None
    if layers is not None:
        preds_emb = preds_emb.reshape(-1, *preds_emb.shape[2:])
        target_emb = target_emb.reshape(-1, *target_emb.shape[2:])

    def _tile(x: Optional[Tensor]) -> Optional[Tensor]:
        return x if x is None or layers is None else x.repeat(layers, 1)

    preds_mask, target_mask = _tile(preds_mask), _tile(target_mask)
    preds_weights, target_weights = _tile(preds_weights), _tile(target_weights)

    def _norm(e: Tensor, m: Tensor) -> Tensor:
        # 1e-12 is a normal float32: no flush-to-zero question arises for this floor
        e = e.to(torch.float32)
        e = e / torch.clamp(torch.linalg.vector_norm(e, dim=-1, keepdim=True), min=1e-12)
        return e * m.to(torch.float32)[..., None]

    p = _norm(preds_emb, preds_mask)
    t = _norm(target_emb, target_mask)
    with full_float32():
        cos_sim = torch.bmm(p, t.transpose(1, 2))
    # a padded position must not clamp a negative best match to 0, nor win the max
    pm = preds_mask.to(torch.float32) > 0
    tm = target_mask.to(torch.float32) > 0
    cos_sim = torch.where(pm[:, :, None] & tm[:, None, :], cos_sim, torch.full((), -1e9, device=cos_sim.device))

    def _weights(explicit: Optional[Tensor], mask: Tensor) -> Tensor:
        mask = mask.to(torch.float32)
        w = explicit.to(torch.float32) * mask if explicit is not None else mask
        return w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)

    pw = _weights(preds_weights, preds_mask)
    tw = _weights(target_weights, target_mask)
    any_t = torch.any(tm, dim=-1, keepdim=True)
    any_p = torch.any(pm, dim=-1, keepdim=True)
    zero = torch.zeros((), device=cos_sim.device)
    best_p = torch.where(any_t, torch.amax(cos_sim, dim=2), zero)
    best_t = torch.where(any_p, torch.amax(cos_sim, dim=1), zero)
    precision = torch.sum(best_p * pw, dim=-1)
    recall = torch.sum(best_t * tw, dim=-1)
    f1 = 2 * precision * recall / (precision + recall)
    f1 = torch.where(torch.isnan(f1), zero, f1)
    out = {"precision": precision, "recall": recall, "f1": f1}
    if layers is not None:
        out = {k: v.reshape(layers, -1) for k, v in out.items()}
    return out


def _pad_seq(x: Tensor, axis: int, n: int) -> Tensor:
    """``x`` with ``n`` zeros appended along ``axis``."""
    if n == 0:
        return x
    shape = list(x.shape)
    shape[axis] = n
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def bert_score(
    preds: Union[str, List[str]],
    target: Union[str, List[str]],
    model_name_or_path: Optional[str] = None,
    encoder: Optional[Encoder] = None,
    tokenize: Optional[Tokenize] = None,
    num_layers: Optional[int] = None,
    max_length: int = 512,
    idf: bool = False,
    rescale_with_baseline: bool = False,
    baseline_path: Optional[str] = None,
    lang: str = "en",
    device=None,
    **reference_kwargs,
) -> Dict[str, Tensor]:
    """BERTScore (JAX ``bert.py:113``): greedy contextual-embedding matching P/R/F1 on ``device``.

    Provide ``encoder`` (see the module docstring), the reference's ``own_model`` / ``user_tokenizer`` /
    ``user_forward_fn`` hooks, or a HuggingFace ``model_name_or_path`` in the local cache; with none,
    the reference's default (``roberta-large``) with its warning. ``idf=True`` weights the matches by
    inverse document frequencies over the target corpus and needs token ids (``tokenize`` beside a
    custom ``encoder``). ``rescale_with_baseline=True`` rescales the three scores with the table at
    ``baseline_path``; ``lang`` only named the reference's download and changes nothing. ``device``
    is where the scores live (CUDA unless named); ``verbose``, ``batch_size`` and ``num_threads`` are
    accepted and inert, and any other keyword raises ``TypeError``.
    """
    unknown = sorted(set(reference_kwargs) - _INERT - _SUPPORTED)
    if unknown:
        raise TypeError(f"bert_score() got unexpected keyword arguments {unknown}")
    dev = resolve_device(device)
    all_layers = bool(reference_kwargs.get("all_layers", False))
    return_hash = bool(reference_kwargs.get("return_hash", False))
    own_model = reference_kwargs.get("own_model")
    user_tokenizer = reference_kwargs.get("user_tokenizer")
    user_forward_fn = reference_kwargs.get("user_forward_fn")
    hooks = own_model is not None or user_tokenizer is not None or user_forward_fn is not None
    if all_layers and (
        (encoder is not None and not getattr(encoder, "layer_stacked", False)) or user_forward_fn is not None
    ):
        # an encoder tagged `layer_stacked` (utils.pretrained's all_layers adapters) already returns
        # the (N, Λ, L, D) stack, so it composes
        raise ValueError("The option `all_layers=True` can be used only with default `transformers` models.")
    if encoder is not None and hooks:
        raise ValueError(
            "Pass either `encoder` or the `own_model`/`user_tokenizer`/`user_forward_fn` hooks,"
            " not both — silently preferring one of them would misreport which model was scored."
        )
    preds = [preds] if isinstance(preds, str) else list(preds)
    target = [target] if isinstance(target, str) else list(target)
    if len(preds) != len(target):
        raise ValueError(f"Number of predicted and reference sentences must match: {len(preds)} != {len(target)}")
    if encoder is None and hooks:
        # any of the three hooks may be combined with an HF-resolved model or tokenizer for the others
        from torchmetrics_tpu_torch.utils.pretrained import hf_bert_model_and_tokenizer, torch_bert_encoder

        model, tok = own_model, user_tokenizer
        if model is None or tok is None:  # resolve only the missing pieces from the checkpoint id
            if own_model is not None and model_name_or_path is None:
                raise ValueError("`own_model` requires `user_tokenizer` (no checkpoint id to resolve one from).")
            model_name_or_path = model_name_or_path or _DEFAULT_MODEL  # keep return_hash truthful
            hf_model, hf_tok = hf_bert_model_and_tokenizer(
                model_name_or_path, load_model=model is None, load_tokenizer=tok is None, device=dev,
            )
            model = model if model is not None else hf_model
            tok = tok if tok is not None else hf_tok
        encoder, tokenize = torch_bert_encoder(
            model, tok, forward_fn=user_forward_fn, num_layers=num_layers, max_length=max_length,
            all_layers=all_layers, device=dev,
        )
    elif encoder is None:
        if model_name_or_path is None:
            rank_zero_warn(
                "The argument `model_name_or_path` was not specified while it is required when the default"
                " `transformers` model is used."
                f" It will use the default recommended model - {_DEFAULT_MODEL!r}."
            )
            model_name_or_path = _DEFAULT_MODEL
        from torchmetrics_tpu_torch.utils.pretrained import bert_encoder as _build

        encoder, tokenize = _build(
            model_name_or_path, num_layers=num_layers, max_length=max_length, all_layers=all_layers, device=dev
        )

    p_weights = t_weights = None
    if idf:
        if tokenize is None:
            raise ValueError(
                "`idf=True` needs token ids: pass `tokenize` alongside a custom `encoder`, or use a"
                " HuggingFace `model_name_or_path` so the tokenizer is resolved automatically."
            )
        t_ids, t_idf_mask = tokenize(list(target))
        p_ids, p_idf_mask = tokenize(list(preds))
        idf_table = _tokens_idf(t_ids, t_idf_mask)
        p_weights = torch.from_numpy(_idf_weights(p_ids, idf_table)).to(dev)
        t_weights = torch.from_numpy(_idf_weights(t_ids, idf_table)).to(dev)

    p_emb, p_mask = encoder(list(preds))
    t_emb, t_mask = encoder(list(target))
    p_emb, t_emb = _as_tensor(p_emb, dev, torch.float32), _as_tensor(t_emb, dev, torch.float32)
    p_mask, t_mask = _as_tensor(p_mask, dev), _as_tensor(t_mask, dev)
    # pad to a common sequence length so that the cosine matrix is rectangular; with all_layers the
    # embeddings carry a layer axis at dim 1: (N, Λ, L, D)
    seq_ax = 2 if p_emb.ndim == 4 else 1
    lp, lt = p_emb.shape[seq_ax], t_emb.shape[seq_ax]
    width = max(lp, lt)
    p_emb, t_emb = _pad_seq(p_emb, seq_ax, width - lp), _pad_seq(t_emb, seq_ax, width - lt)
    p_mask, t_mask = _pad_seq(p_mask, 1, width - lp), _pad_seq(t_mask, 1, width - lt)
    if p_weights is not None:
        # tokenize() and encoder() pad independently: fit the idf grids to the embedding grid
        def _fit(w: Tensor, length: int) -> Tensor:
            return _pad_seq(w, 1, max(0, length - w.shape[1]))[:, :length]

        p_weights = _fit(p_weights, p_mask.shape[1])
        t_weights = _fit(t_weights, t_mask.shape[1])

    if p_emb.ndim == 4:  # all_layers: the layer axis first, batched into the product -> (Λ, N) scores
        p_emb, t_emb = p_emb.transpose(0, 1), t_emb.transpose(0, 1)
    out = _bert_score_from_embeddings(p_emb, p_mask, t_emb, t_mask, p_weights, t_weights)

    if rescale_with_baseline:
        if baseline_path is None:
            rank_zero_warn("Baseline was not successfully loaded. No baseline is going to be used.")
        else:
            baseline = torch.from_numpy(_load_baseline_file(baseline_path)).to(dev)
            if all_layers:  # per-layer rows, broadcast over the sentences (JAX bert.py:258-272)
                row = baseline[: out["precision"].shape[0], :, None]
                rows = (row[:, 0], row[:, 1], row[:, 2])
            else:
                raw = baseline[num_layers if num_layers is not None else -1]
                rows = (raw[0], raw[1], raw[2])
            out = {key: (out[key] - r) / (1 - r) for key, r in zip(("precision", "recall", "f1"), rows)}
    if return_hash:
        # a caller's encoder has no resolved checkpoint name; "None_L..." would misreport the model
        name = model_name_or_path if model_name_or_path is not None else "custom-encoder"
        out["hash"] = f"{name}_L{num_layers}{'_idf' if idf else '_no-idf'}"
    return out
