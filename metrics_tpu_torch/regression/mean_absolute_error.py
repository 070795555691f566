"""MeanAbsoluteError module. Counterpart of ``metrics_tpu/regression/mean_absolute_error.py``."""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.mean_absolute_error import (
    _mean_absolute_error_compute,
    _mean_absolute_error_update,
)


class MeanAbsoluteError(Metric):
    """Accumulated mean absolute error: a float32 sum and an int64 count.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> mean_absolute_error = MeanAbsoluteError(device="cpu")
        >>> float(mean_absolute_error(preds, target))
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
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, dist_sync_fn=dist_sync_fn, device=device)
        self.add_state("sum_abs_error", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_abs_error, n_obs = _mean_absolute_error_update(preds, target)
        self.sum_abs_error = self.sum_abs_error + sum_abs_error
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return _mean_absolute_error_compute(self.sum_abs_error, self.total)
