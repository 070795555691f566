"""Binned curve metric modules: O(1) ``(T,)`` / ``(C, T)`` int64 "sum" states.

Counterpart of ``metrics_tpu/classification/binned.py``. The threshold grid
becomes a tensor on the metric's device, registered once at construction, so
an update pays no host-to-device copy. It is ranked for kernel K1 when the
metric is built and again whenever ``.to()`` moves it, never per update; on a
CUDA device a binary update runs K1 (``csrc/binned_counts.cu``) as one launch.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.binned_curves import (
    _as_thresholds,
    _auroc,
    _average_precision,
    _precision_recall,
    _roc,
    binned_stat_curve_update,
)
from metrics_tpu_torch.ops.binned import rank_thresholds


class _BinnedCurveMetric(Metric):
    """Shared machinery: accumulate per-threshold confusion counts."""

    def __init__(
        self,
        num_classes: Optional[int] = None,
        thresholds: Union[int, Tensor, list, None] = None,
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
        self.num_classes = num_classes
        self.register_buffer("thresholds", _as_thresholds(thresholds, self.device), persistent=False)
        self._ranked = rank_thresholds(self.thresholds)
        num_t = self.thresholds.shape[0]
        shape = (num_t,) if num_classes is None else (num_classes, num_t)
        # per-batch float32 counts are exact below 2**24; the int64 states hold the totals
        for name in ("tp", "fp", "tn", "fn"):
            self.add_state(name, default=torch.zeros(shape, dtype=torch.int64), dist_reduce_fx="sum")

    def _apply(self, fn: Callable, *args: Any, **kwargs: Any) -> "_BinnedCurveMetric":
        super()._apply(fn, *args, **kwargs)
        self._ranked = rank_thresholds(self.thresholds)  # the grid moved: rank it where it lies now
        return self

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.num_classes is not None and preds.ndim == 1:
            raise ValueError(f"Expected per-class predictions (N, {self.num_classes}), got 1d input.")
        if self.num_classes is None and preds.ndim > 1:
            raise ValueError(
                "Got 2d per-class predictions but `num_classes` was not set; "
                "construct the metric with num_classes=C for multiclass/multilabel input."
            )
        tp, fp, tn, fn = binned_stat_curve_update(
            preds.to(torch.float32), target, self.thresholds, ranked=self._ranked
        )
        self.tp = self.tp + tp.to(torch.int64)
        self.fp = self.fp + fp.to(torch.int64)
        self.tn = self.tn + tn.to(torch.int64)
        self.fn = self.fn + fn.to(torch.int64)


class BinnedPrecisionRecallCurve(_BinnedCurveMetric):
    """PR curve on a fixed threshold grid.

    Example:
        >>> import torch
        >>> m = BinnedPrecisionRecallCurve(thresholds=torch.tensor([0.0, 0.5, 1.0]), device="cpu")
        >>> p, r, t = m(torch.tensor([0.1, 0.4, 0.6, 0.8]), torch.tensor([0, 1, 1, 1]))
        >>> p.tolist()
        [0.75, 1.0, 0.0]
    """

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        precision, recall = _precision_recall(self.tp, self.fp, self.fn)
        return precision, recall, self.thresholds


class BinnedROC(_BinnedCurveMetric):
    """ROC on a fixed threshold grid."""

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        fpr, tpr = _roc(self.tp, self.fp, self.tn, self.fn)
        return fpr, tpr, self.thresholds


class BinnedAUROC(_BinnedCurveMetric):
    """AUROC from binned counts (converges to exact as the grid refines)."""

    def compute(self) -> Tensor:
        return _auroc(*_roc(self.tp, self.fp, self.tn, self.fn))


class BinnedAveragePrecision(_BinnedCurveMetric):
    """Average precision from binned counts."""

    def compute(self) -> Tensor:
        return _average_precision(*_precision_recall(self.tp, self.fp, self.fn))
