"""SacreBLEU tokenization + score.

Counterpart of ``metrics_tpu/functional/text_sacrebleu.py``, the regex tables
copied verbatim. SacreBLEU's contribution is the STANDARDIZED tokenization (mteval-v13a by
default) applied to raw detokenized strings before ordinary corpus BLEU —
the semantics re-derived here from the published mteval-v13a rules, not a
code port. The score itself reuses the BLEU statistics counted on the
device (``functional/nlp.py``): clipped n-gram precisions, brevity penalty,
geometric mean, optional add-1 smoothing.
"""
import re
from typing import List, Optional, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.nlp import bleu_score

TOKENIZERS = ("13a", "none", "char")

# mteval-v13a language-independent normalizations, then punctuation splits
_13A_NORM = (
    ("<skipped>", ""),
    ("-\n", ""),
    ("\n", " "),
    ("&quot;", '"'),
    ("&amp;", "&"),
    ("&lt;", "<"),
    ("&gt;", ">"),
)
_13A_SPLITS = (
    # space around punctuation (not . or , which are number-sensitive)
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    # period/comma unless surrounded by digits
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    # dash after a digit
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
)


def _tokenize_13a(line: str) -> List[str]:
    for old, new in _13A_NORM:
        line = line.replace(old, new)
    line = f" {line} "
    for pattern, repl in _13A_SPLITS:
        line = pattern.sub(repl, line)
    return line.split()


def tokenize_sacrebleu(line: str, tokenize: str = "13a", lowercase: bool = False) -> List[str]:
    """Tokenize one raw string with a sacrebleu tokenizer variant."""
    if tokenize not in TOKENIZERS:
        raise ValueError(f"`tokenize` must be one of {TOKENIZERS}, got {tokenize!r}")
    if lowercase:
        line = line.lower()
    if tokenize == "13a":
        return _tokenize_13a(line)
    if tokenize == "char":
        # sacrebleu parity: whitespace is dropped, not kept as tokens
        return [c for c in line if not c.isspace()]
    return line.split()


def sacre_bleu_score(
    preds: Sequence[str],
    target: Sequence[Sequence[str]],
    n_gram: int = 4,
    smooth: bool = False,
    tokenize: str = "13a",
    lowercase: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Corpus BLEU over raw strings with sacrebleu tokenization.

    ``preds`` are hypothesis strings; ``target[i]`` is the list of reference
    strings for hypothesis ``i``. ``device``: where the n-grams are counted
    and the score lives (``None``: ``cuda``).

    Example:
        >>> preds = ["the cat is on the mat"]
        >>> target = [["there is a cat on the mat", "a cat is on the mat"]]
        >>> round(float(sacre_bleu_score(preds, target, device="cpu")), 4)
        0.7598
    """
    tok_preds = [tokenize_sacrebleu(p, tokenize, lowercase) for p in preds]
    tok_target: List[List[List[str]]] = [
        [tokenize_sacrebleu(r, tokenize, lowercase) for r in refs] for refs in target
    ]
    return bleu_score(tok_preds, tok_target, n_gram=n_gram, smooth=smooth, device=device)
