"""ROUGEScore module. Counterpart of ``metrics_tpu/text/rouge.py``.

Streams the per-sentence precision/recall/F1 sums per rouge key (float32)
plus a pair count (int64), so the accumulated value is the mean of
per-sentence scores over everything seen (the rouge_score aggregation
convention) and sync is one summed reduction a dtype. A batch above 50,000
LCS cells runs its ROUGE-L DP on the metric's device.
"""
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text_rouge import ROUGE_KEYS, _batch_sums, _check_rouge_keys
from metrics_tpu_torch.utils.data import accum_int_dtype

_STATS = ("precision", "recall", "fmeasure")


class ROUGEScore(Metric):
    r"""Accumulated ROUGE-N / ROUGE-L scores (mean of per-sentence values).

    Example:
        >>> metric = ROUGEScore(rouge_keys=("rouge1",), device="cpu")
        >>> out = metric(["the cat sat on the mat"], ["the cat was on the mat"])
        >>> round(float(out["rouge1_fmeasure"]), 4)
        0.8333
    """

    def __init__(
        self,
        rouge_keys: Sequence[str] = ROUGE_KEYS,
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
        self.rouge_keys = _check_rouge_keys(rouge_keys)
        for key in self.rouge_keys:
            for stat in _STATS:
                self.add_state(f"{key}_{stat}_sum", default=torch.zeros((), dtype=torch.float32),
                               dist_reduce_fx="sum")
        self.add_state("pairs", default=torch.zeros((), dtype=accum_int_dtype()), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        sums, n = _batch_sums(preds, target, self.rouge_keys, self.device)
        self.note_count(n)
        for key, values in sums.items():
            for stat, value in zip(_STATS, values):
                name = f"{key}_{stat}_sum"
                setattr(self, name, getattr(self, name) + value)
        self.pairs = self.pairs + n

    def compute(self) -> Dict[str, Tensor]:
        n = torch.clamp_min(self.pairs, 1).to(torch.float32)
        return {
            f"{key}_{stat}": getattr(self, f"{key}_{stat}_sum") / n
            for key in self.rouge_keys
            for stat in _STATS
        }
