"""MAPE / SMAPE / WMAPE modules: two ``"sum"`` states each.

Counterpart of ``metrics_tpu/regression/mape.py``.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.mape import _EPS, _mape_update, _smape_update, _wmape_update


class _RatioSumMetric(Metric):
    """A float32 sum of ratios over an int64 count, shared by MAPE and SMAPE."""

    def __init__(
        self,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, dist_sync_fn=dist_sync_fn, device=device)
        self.add_state("sum_ratio", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def _add(self, sum_ratio: Tensor, n_obs: int) -> None:
        self.sum_ratio = self.sum_ratio + sum_ratio
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return self.sum_ratio / torch.clamp_min(self.total, 1).to(torch.float32)


class MeanAbsolutePercentageError(_RatioSumMetric):
    r"""Accumulated MAPE: mean of ``|preds - target| / max(|target|, eps)``.

    Example:
        >>> import torch
        >>> target = torch.tensor([1.0, 10.0, 1e6])
        >>> preds = torch.tensor([0.9, 15.0, 1.2e6])
        >>> mape = MeanAbsolutePercentageError(device="cpu")
        >>> round(float(mape(preds, target)), 4)
        0.2667
    """

    def update(self, preds: Tensor, target: Tensor) -> None:
        self._add(*_mape_update(preds, target))


class SymmetricMeanAbsolutePercentageError(_RatioSumMetric):
    r"""Accumulated SMAPE: mean of ``2 |p - t| / max(|p| + |t|, eps)``.

    Example:
        >>> import torch
        >>> target = torch.tensor([1.0, 10.0, 1e6])
        >>> preds = torch.tensor([0.9, 15.0, 1.2e6])
        >>> smape = SymmetricMeanAbsolutePercentageError(device="cpu")
        >>> round(float(smape(preds, target)), 4)
        0.229
    """

    def update(self, preds: Tensor, target: Tensor) -> None:
        self._add(*_smape_update(preds, target))


class WeightedMeanAbsolutePercentageError(Metric):
    r"""Accumulated WMAPE: ``sum |preds - target| / sum |target|``.

    Example:
        >>> import torch
        >>> target = torch.tensor([1.0, 10.0, 100.0])
        >>> preds = torch.tensor([0.9, 15.0, 110.0])
        >>> wmape = WeightedMeanAbsolutePercentageError(device="cpu")
        >>> round(float(wmape(preds, target)), 4)
        0.136
    """

    def __init__(
        self,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, dist_sync_fn=dist_sync_fn, device=device)
        self.add_state("sum_abs_error", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("sum_abs_target", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        abs_error, abs_target = _wmape_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + abs_error
        self.sum_abs_target = self.sum_abs_target + abs_target

    def compute(self) -> Tensor:
        return self.sum_abs_error / torch.clamp_min(self.sum_abs_target, _EPS)
