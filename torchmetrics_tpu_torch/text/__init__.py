"""Text module metrics of the port (counterpart of ``torchmetrics_tpu/text/__init__.py``): the 14 that
need no model, and the encoder-backed ``BERTScore`` and ``InfoLM``."""
from torchmetrics_tpu_torch.text.metrics import (
    BERTScore,
    BLEUScore,
    CharErrorRate,
    CHRFScore,
    EditDistance,
    ExtendedEditDistance,
    InfoLM,
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
    "BERTScore",
    "BLEUScore",
    "InfoLM",
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
