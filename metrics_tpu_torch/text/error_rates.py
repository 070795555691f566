"""CharErrorRate / MatchErrorRate / WordInfoPreserved / WordInfoLost modules.

Counterpart of ``metrics_tpu/text/error_rates.py``. All stream through int64
sum-states of the per-pair alignment statistics (edit errors, aligned hits,
reference/prediction lengths), so accumulation is O(1) and sync is one summed
reduction — the global value equals the value over the concatenated corpus.
"""
from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text import TokenSeq, _chars, _sequence_stats, _tokens
from metrics_tpu_torch.utils.data import accum_int_dtype


class _AlignmentStatsMetric(Metric):
    """Accumulates (errors, hits, target len, pred len) over sequence pairs."""

    _tokenize = staticmethod(_tokens)
    _need_hits = True

    def __init__(
        self,
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
        for name in ("errors", "hits", "total_target", "total_pred"):
            self.add_state(name, default=torch.zeros((), dtype=accum_int_dtype()), dist_reduce_fx="sum")

    def update(self, preds: Union[TokenSeq, Sequence[TokenSeq]], target: Union[TokenSeq, Sequence[TokenSeq]]) -> None:
        errors, hits, total_t, total_p = _sequence_stats(preds, target, self._tokenize, self._need_hits)
        self.note_count(max(errors, hits, total_t, total_p))
        self.errors = self.errors + errors
        self.hits = self.hits + hits
        self.total_target = self.total_target + total_t
        self.total_pred = self.total_pred + total_p


class CharErrorRate(_AlignmentStatsMetric):
    r"""Accumulated character error rate (edit distance over characters /
    reference characters; spaces count as characters).

    Example:
        >>> metric = CharErrorRate(device="cpu")
        >>> float(metric(["abcd"], ["abce"]))
        0.25
    """

    _tokenize = staticmethod(_chars)
    _need_hits = False  # CER needs only the distance

    def compute(self) -> Tensor:
        rate = self.errors.to(torch.float32) / torch.clamp_min(self.total_target, 1).to(torch.float32)
        return torch.where(self.total_target == 0, torch.where(self.errors == 0, 0.0, float("inf")), rate)


class MatchErrorRate(_AlignmentStatsMetric):
    r"""Accumulated match error rate: ``(S+D+I) / (H+S+D+I)`` over all pairs.

    Example:
        >>> metric = MatchErrorRate(device="cpu")
        >>> float(metric(["the cat sat"], ["the cat sat on the mat"]))
        0.5
    """

    def compute(self) -> Tensor:
        denom = (self.errors + self.hits).to(torch.float32)
        return torch.where(denom == 0, 0.0, self.errors.to(torch.float32) / torch.clamp_min(denom, 1.0))


class WordInfoPreserved(_AlignmentStatsMetric):
    r"""Accumulated word information preserved: ``(H/N_target) * (H/N_pred)``.

    Example:
        >>> metric = WordInfoPreserved(device="cpu")
        >>> float(metric(["the cat sat"], ["the cat sat on the mat"]))
        0.5
    """

    def compute(self) -> Tensor:
        h = self.hits.to(torch.float32)
        nt = torch.clamp_min(self.total_target, 1).to(torch.float32)
        np_ = torch.clamp_min(self.total_pred, 1).to(torch.float32)
        return torch.where((self.total_target == 0) | (self.total_pred == 0), 0.0, (h / nt) * (h / np_))


class WordInfoLost(WordInfoPreserved):
    r"""Accumulated word information lost: ``1 - WIP``.

    Example:
        >>> metric = WordInfoLost(device="cpu")
        >>> float(metric(["the cat sat"], ["the cat sat on the mat"]))
        0.5
    """

    def compute(self) -> Tensor:
        return 1.0 - super().compute()
