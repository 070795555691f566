"""MedianAbsoluteError module: the median of ``|preds - target|`` from a quantile sketch.

Counterpart of ``metrics_tpu/regression/median_absolute_error.py``. The
absolute errors fold into a constant-memory
:class:`~metrics_tpu_torch.parallel.qsketch.QuantileSketch` (relative accuracy
``alpha``), and ``compute`` reports its p50, with the same certificate as
:class:`~metrics_tpu_torch.regression.quantile.Quantile`.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.parallel.qsketch import (
    QSKETCH_ALPHA,
    QSKETCH_MAX_VALUE,
    QSKETCH_MIN_VALUE,
    QuantileSketch,
    qsketch_update,
    qsketch_value_group_key,
    quantile_error_bound,
    quantile_from_counts,
    quantile_sketch_spec,
)
from metrics_tpu_torch.utils.checks import _check_same_shape

__all__ = ["MedianAbsoluteError"]


class MedianAbsoluteError(Metric):
    r"""Median absolute error ``median(|preds - target|)`` over all data seen, to
    relative accuracy ``alpha``. Errors below ``min_value`` report exactly 0.0;
    NaN pairs are dropped; ``±inf`` errors land in the overflow bucket
    (flagged by :meth:`error_bound`).

    Example:
        >>> import torch
        >>> target = torch.tensor([2.5, 5.0, 4.0, 8.0])
        >>> preds = torch.tensor([3.0, 5.0, 2.0, 7.0])
        >>> mdae = MedianAbsoluteError(device="cpu")
        >>> round(float(mdae(preds, target)), 2)
        0.5
    """

    def __init__(
        self,
        alpha: float = QSKETCH_ALPHA,
        min_value: float = QSKETCH_MIN_VALUE,
        max_value: float = QSKETCH_MAX_VALUE,
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
        spec = quantile_sketch_spec(alpha, min_value, max_value)
        self.alpha = spec.alpha
        self.min_value = spec.min_value
        self.max_value = spec.max_value
        self.add_state("qsketch", default=spec, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        _check_same_shape(preds, target)
        err = torch.abs(preds - target)
        self.qsketch = QuantileSketch(
            qsketch_update(self.qsketch.counts, err, self.alpha, self.min_value, self.max_value)
        )

    def _group_fingerprint(self) -> Optional[Any]:
        # its own tag: the update folds |preds - target|, not raw values, so its
        # deltas are not the Quantile family's
        return ("qsketch_mae",) + qsketch_value_group_key(self)[1:]

    def compute(self) -> Tensor:
        return quantile_from_counts(self.qsketch.counts, 0.5, self.alpha, self.min_value, self.max_value)

    def error_bound(self) -> Tensor:
        """Certificate: ``|estimate - true median| <= alpha * true + min_value``
        while the median rank resolves inside the certified span (``inf`` from
        the overflow bucket)."""
        return quantile_error_bound(self.qsketch.counts, 0.5, self.alpha, self.min_value, self.max_value)
