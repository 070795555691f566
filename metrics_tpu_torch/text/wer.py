"""WER module. Counterpart of ``metrics_tpu/text/wer.py``.

Streams through two scalar int64 sum-states (edit errors / reference words),
so accumulation is O(1) and cross-process sync is one summed reduction.
"""
from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text import TokenSeq, _wer_update
from metrics_tpu_torch.utils.data import accum_int_dtype
from metrics_tpu_torch.utils.device import check_same_device


class WER(Metric):
    r"""Accumulated word error rate over sequence pairs.

    Accepts strings (whitespace-tokenized) or pre-tokenized sequences, and
    also pre-computed device results via ``update_counts`` for pipelines that
    run the batched edit-distance DP on the card
    (``functional.edit_distance_padded``).

    Example:
        >>> metric = WER(device="cpu")
        >>> float(metric(["the cat sat"], ["the cat sat on the mat"]))
        0.5
    """

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
        self.add_state("errors", default=torch.zeros((), dtype=accum_int_dtype()), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=accum_int_dtype()), dist_reduce_fx="sum")

    def update(self, preds: Union[TokenSeq, Sequence[TokenSeq]], target: Union[TokenSeq, Sequence[TokenSeq]]) -> None:
        errors, total = _wer_update(preds, target)
        # host inputs (strings/token lists) carry no size for the automatic
        # bound; the counts are host ints here, so advance it exactly
        self.note_count(max(int(errors), int(total)))
        self.errors = self.errors + errors
        self.total = self.total + total

    def update_counts(self, errors: Tensor, ref_words: Tensor) -> None:
        """Accumulate pre-computed device counts (e.g. from
        ``edit_distance_padded`` distances and target lengths).

        The counts live on the device, so the count bound can only be advanced
        by the sequence count here (no device read); when you know the padded
        sequence length ``M``, call ``self.note_count(B * M)`` yourself for a
        tight bound (reference words per sequence are ≤ M).
        """
        check_same_device(self.device, errors, ref_words)
        self._computed = None  # bypasses the wrapped update, so drop its cache here
        self.note_count(ref_words.numel())
        self.errors = self.errors + errors.sum(dtype=self.errors.dtype)
        self.total = self.total + ref_words.sum(dtype=self.total.dtype)

    def compute(self) -> Tensor:
        # empty reference: 0.0 for a perfect empty match, inf when there are
        # errors (matching the functional)
        rate = self.errors.to(torch.float32) / torch.clamp_min(self.total, 1).to(torch.float32)
        return torch.where(self.total == 0, torch.where(self.errors == 0, 0.0, float("inf")), rate)
