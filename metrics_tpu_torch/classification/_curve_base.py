"""Shared constructor of the exact curve metrics (AUROC, AveragePrecision, ROC,
PrecisionRecallCurve): two cat states, ``preds`` and ``target``."""
from typing import Any, Callable, Optional, Union

import torch

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.prints import rank_zero_warn_once


def check_approx(approx: Optional[str], allowed: tuple) -> None:
    """The exact mode is the only one ported: the sketch modes raise."""
    if approx is not None and approx not in allowed:
        raise ValueError(f"`approx` must be None or one of {allowed}, got {approx!r}")
    if approx is not None:
        raise NotImplementedError(
            f"approx={approx!r} needs the mergeable sketch states, which metrics_tpu_torch has not ported yet"
            " (ROADMAP.md, section 1, item 4); the exact mode (approx=None) is ported."
        )


class _ExactCurveMetric(Metric):
    """A curve metric over every prediction seen: ``preds`` / ``target`` cat
    states (lists, or PaddedBuffers with ``capacity``)."""

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        capacity: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
            capacity=capacity,
        )
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.add_state("preds", default=[], dist_reduce_fx=None)
        self.add_state("target", default=[], dist_reduce_fx=None)
        rank_zero_warn_once(
            f"Metric `{type(self).__name__}` stores every prediction and target in an O(samples)"
            " buffer state, so memory and sync traffic grow with the dataset. The binned curve"
            " metrics keep O(thresholds) states and sync with one all_reduce."
        )
