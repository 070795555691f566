"""Text metrics. Counterpart of ``metrics_tpu/text/``."""
from metrics_tpu_torch.text.wer import WER
from metrics_tpu_torch.text.error_rates import (
    CharErrorRate,
    MatchErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)
from metrics_tpu_torch.text.perplexity import Perplexity
from metrics_tpu_torch.text.bleu import BLEUScore, SacreBLEUScore
from metrics_tpu_torch.text.chrf import CHRFScore
from metrics_tpu_torch.text.edit import EditDistance
from metrics_tpu_torch.text.rouge import ROUGEScore
from metrics_tpu_torch.text.squad import SQuAD
from metrics_tpu_torch.text.ter import TranslationEditRate

__all__ = [
    "BLEUScore",
    "CHRFScore",
    "CharErrorRate",
    "EditDistance",
    "MatchErrorRate",
    "Perplexity",
    "ROUGEScore",
    "SQuAD",
    "SacreBLEUScore",
    "TranslationEditRate",
    "WER",
    "WordInfoLost",
    "WordInfoPreserved",
]
