"""Stateful multilabel ranking metrics.

Counterpart of ``metrics_tpu/classification/ranking.py``: each streams a
float32 per-sample total and an int64 sample count, both "sum" states.
Semantics (ties, degenerate rows) are sklearn's; see
``functional/classification/ranking.py``.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.ranking import (
    _coverage_error_update,
    _label_ranking_ap_update,
    _label_ranking_loss_update,
)


class _RankingMetric(Metric):
    """Shared streaming base: accumulate (per-sample total, sample count)."""

    _update_fn: Optional[Callable[[Tensor, Tensor], Tuple[Tensor, Tensor]]] = None

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
        self.add_state("measure", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        measure, n = type(self)._update_fn(preds, target)
        self.measure = self.measure + measure
        self.total = self.total + n

    def compute(self) -> Tensor:
        return self.measure / torch.clamp_min(self.total.to(torch.float32), 1.0)


class CoverageError(_RankingMetric):
    """Multilabel coverage error (sklearn ``coverage_error``).

    Example:
        >>> import torch
        >>> metric = CoverageError(device="cpu")
        >>> _ = metric(torch.tensor([[0.9, 0.1, 0.5]]), torch.tensor([[1, 0, 1]]))
        >>> _ = metric(torch.tensor([[0.2, 0.8, 0.6]]), torch.tensor([[0, 1, 0]]))
        >>> float(metric.compute())
        1.5
    """

    _update_fn = staticmethod(_coverage_error_update)


class LabelRankingAveragePrecision(_RankingMetric):
    """Label-ranking average precision (sklearn ``label_ranking_average_precision_score``).

    Example:
        >>> import torch
        >>> metric = LabelRankingAveragePrecision(device="cpu")
        >>> _ = metric(torch.tensor([[0.75, 0.5, 1.0]]), torch.tensor([[1, 0, 0]]))
        >>> _ = metric(torch.tensor([[1.0, 0.2, 0.1]]), torch.tensor([[0, 0, 1]]))
        >>> round(float(metric.compute()), 4)
        0.4167
    """

    _update_fn = staticmethod(_label_ranking_ap_update)


class LabelRankingLoss(_RankingMetric):
    """Label ranking loss (sklearn ``label_ranking_loss``).

    Example:
        >>> import torch
        >>> metric = LabelRankingLoss(device="cpu")
        >>> _ = metric(torch.tensor([[0.2, 0.8, 0.6]]), torch.tensor([[0, 1, 0]]))
        >>> _ = metric(torch.tensor([[0.9, 0.6, 0.5]]), torch.tensor([[1, 0, 1]]))
        >>> float(metric.compute())
        0.25
    """

    _update_fn = staticmethod(_label_ranking_loss_update)
