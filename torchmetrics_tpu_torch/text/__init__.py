"""Text module metrics of the port (counterpart of ``torchmetrics_tpu/text/__init__.py``), less
``BERTScore`` and ``InfoLM``, which wait for the encoder-backed slice."""
from torchmetrics_tpu_torch.text.metrics import (
    BLEUScore,
    CharErrorRate,
    CHRFScore,
    EditDistance,
    ExtendedEditDistance,
    MatchErrorRate,
    Perplexity,
    ROUGEScore,
    SacreBLEUScore,
    SQuAD,
    TranslationEditRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)

__all__ = [
    "BLEUScore",
    "CHRFScore",
    "CharErrorRate",
    "EditDistance",
    "ExtendedEditDistance",
    "MatchErrorRate",
    "ROUGEScore",
    "TranslationEditRate",
    "Perplexity",
    "SQuAD",
    "SacreBLEUScore",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
]
