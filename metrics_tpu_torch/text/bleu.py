"""BLEUScore / SacreBLEUScore modules. Counterpart of ``metrics_tpu/text/bleu.py``.

The sufficient statistics — per-order clipped matches and totals plus the
translation/reference length sums — are all ``"sum"``-reducible, so the
accumulated value is the true CORPUS BLEU of everything seen (not a mean of
batch scores) and sync is one summed reduction a dtype. Counting runs on the
metric's device (``functional/nlp.py::bleu_counts``); only tokenization is
host-side.
"""
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.nlp import _intern_corpus, _pad_corpus, bleu_counts, bleu_from_counts
from metrics_tpu_torch.functional.text_sacrebleu import TOKENIZERS, tokenize_sacrebleu
from metrics_tpu_torch.utils.data import accum_int_dtype

TokenizedOrRaw = Union[str, Sequence[str]]


class BLEUScore(Metric):
    """Accumulated corpus BLEU.

    ``update`` takes hypothesis sentences and per-hypothesis reference
    lists; raw strings are whitespace-split (pass pre-tokenized lists to
    control tokenization, or use :class:`SacreBLEUScore`).

    Example:
        >>> metric = BLEUScore(device="cpu")
        >>> preds = ["the cat is on the mat"]
        >>> target = [["there is a cat on the mat", "a cat is on the mat"]]
        >>> round(float(metric(preds, target)), 4)
        0.7598
    """

    def __init__(
        self,
        n_gram: int = 4,
        smooth: bool = False,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        if not isinstance(n_gram, int) or n_gram < 1:
            raise ValueError(f"`n_gram` must be a positive int, got {n_gram!r}")
        self.n_gram = n_gram
        self.smooth = smooth
        # numerator is fractional (clipped-match ratios), float32 as in the JAX package
        self.add_state("numerator", default=torch.zeros(n_gram, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("denominator", default=torch.zeros(n_gram, dtype=accum_int_dtype()), dist_reduce_fx="sum")
        self.add_state("trans_len", default=torch.zeros((), dtype=accum_int_dtype()), dist_reduce_fx="sum")
        self.add_state("ref_len", default=torch.zeros((), dtype=accum_int_dtype()), dist_reduce_fx="sum")

    def _tok(self, text: TokenizedOrRaw) -> List[str]:
        return text.split() if isinstance(text, str) else list(text)

    def update(self, preds: Sequence[TokenizedOrRaw], target: Sequence[Sequence[TokenizedOrRaw]]) -> None:
        if len(preds) != len(target):
            raise ValueError(f"preds has {len(preds)} sentences, target {len(target)}")
        hyps = [self._tok(p) for p in preds]
        refs = [[self._tok(r) for r in rs] for rs in target]
        hyp_ids, ref_ids = _intern_corpus(hyps, refs)
        num, den, c, r = bleu_counts(*_pad_corpus(hyp_ids, ref_ids, self.device), n_gram=self.n_gram)
        # a bound that dominates EVERY int state increment: denominator/trans_len
        # grow by hyp tokens, ref_len by the closest-reference lengths
        self.note_count(max(
            sum(len(h) for h in hyps),
            sum(max((len(r) for r in rs), default=0) for rs in refs),
        ))
        self.numerator = self.numerator + num
        self.denominator = self.denominator + den
        self.trans_len = self.trans_len + c
        self.ref_len = self.ref_len + r

    def compute(self) -> Tensor:
        return bleu_from_counts(
            self.numerator.to(torch.float32),
            self.denominator.to(torch.float32),
            self.trans_len.to(torch.float32),
            self.ref_len.to(torch.float32),
            smooth=self.smooth,
        )


class SacreBLEUScore(BLEUScore):
    """Corpus BLEU over RAW strings with sacrebleu tokenization (default
    mteval-v13a); otherwise identical statistics and aggregation to
    :class:`BLEUScore`.

    Example:
        >>> metric = SacreBLEUScore(device="cpu")
        >>> preds = ["the cat is on the mat"]
        >>> target = [["there is a cat on the mat", "a cat is on the mat"]]
        >>> round(float(metric(preds, target)), 4)
        0.7598
    """

    def __init__(self, n_gram: int = 4, smooth: bool = False, tokenize: str = "13a",
                 lowercase: bool = False, **kwargs: Any):
        super().__init__(n_gram=n_gram, smooth=smooth, **kwargs)
        if tokenize not in TOKENIZERS:
            raise ValueError(f"`tokenize` must be one of {TOKENIZERS}, got {tokenize!r}")
        self.tokenize = tokenize
        self.lowercase = lowercase

    def _tok(self, text: TokenizedOrRaw) -> List[str]:
        if not isinstance(text, str):
            text = " ".join(text)
        return tokenize_sacrebleu(text, self.tokenize, self.lowercase)
