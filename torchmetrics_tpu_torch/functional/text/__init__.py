"""Functional text metrics of the port (counterpart of ``torchmetrics_tpu/functional/text/``). The entries
that take strings take a ``device`` keyword (CUDA unless named) for the tensors they return. As in JAX,
``bert_score`` and ``infolm`` are attributes of the module but not in its ``__all__``."""
from torchmetrics_tpu_torch.functional.text.bert import bert_score  # noqa: F401
from torchmetrics_tpu_torch.functional.text.bleu import bleu_score
from torchmetrics_tpu_torch.functional.text.chrf import chrf_score
from torchmetrics_tpu_torch.functional.text.edit import edit_distance
from torchmetrics_tpu_torch.functional.text.eed import extended_edit_distance
from torchmetrics_tpu_torch.functional.text.infolm import infolm  # noqa: F401
from torchmetrics_tpu_torch.functional.text.perplexity import perplexity
from torchmetrics_tpu_torch.functional.text.rouge import rouge_score
from torchmetrics_tpu_torch.functional.text.sacre_bleu import sacre_bleu_score
from torchmetrics_tpu_torch.functional.text.squad import squad
from torchmetrics_tpu_torch.functional.text.ter import translation_edit_rate
from torchmetrics_tpu_torch.functional.text.wer import (
    char_error_rate,
    match_error_rate,
    word_error_rate,
    word_information_lost,
    word_information_preserved,
)

__all__ = [
    "bleu_score",
    "char_error_rate",
    "chrf_score",
    "edit_distance",
    "match_error_rate",
    "perplexity",
    "sacre_bleu_score",
    "squad",
    "word_error_rate",
    "word_information_lost",
    "word_information_preserved",
]
