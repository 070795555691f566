"""EditDistance module. Counterpart of ``metrics_tpu/text/edit.py``; the
functional form is ``metrics_tpu_torch.functional.edit_distance``."""
from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text import _np_edit_distance
from metrics_tpu_torch.utils.data import accum_int_dtype


class EditDistance(Metric):
    """Accumulated character-level edit distance over all sentence pairs
    seen (``reduction="mean"``: total distance / total pairs, NaN before any
    pair; ``"sum"``: total distance). Two int64 scalar sum-states.

    Example:
        >>> metric = EditDistance(device="cpu")
        >>> float(metric(["abcd"], ["abce"]))
        1.0
    """

    def __init__(
        self,
        reduction: str = "mean",
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
        if reduction not in ("mean", "sum"):
            raise ValueError(f"`reduction` must be 'mean' or 'sum', got {reduction!r}")
        self.reduction = reduction
        self.add_state("total_distance", default=torch.zeros((), dtype=accum_int_dtype()), dist_reduce_fx="sum")
        self.add_state("pairs", default=torch.zeros((), dtype=accum_int_dtype()), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        preds = [preds] if isinstance(preds, str) else list(preds)
        target = [target] if isinstance(target, str) else list(target)
        if len(preds) != len(target):
            raise ValueError(f"preds has {len(preds)} sentences, target {len(target)}")
        batch = sum(_np_edit_distance(list(p), list(t)) for p, t in zip(preds, target))
        # bound on what this update ADDS to the int states: distance per pair
        # is at most max(len(p), len(t)), summed over the batch
        self.note_count(sum(max(len(p), len(t)) for p, t in zip(preds, target)))
        self.total_distance = self.total_distance + batch
        self.pairs = self.pairs + len(preds)

    def compute(self) -> Tensor:
        total = self.total_distance.to(torch.float32)
        if self.reduction == "sum":
            return total
        pairs = self.pairs.to(torch.float32)
        return torch.where(pairs == 0, float("nan"), total / torch.clamp_min(pairs, 1.0))
