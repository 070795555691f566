"""MeanSquaredLogError module. Counterpart of ``metrics_tpu/regression/mean_squared_log_error.py``."""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.mean_squared_log_error import (
    _mean_squared_log_error_compute,
    _mean_squared_log_error_update,
)


class MeanSquaredLogError(Metric):
    """Accumulated mean squared log error: a float32 sum and an int64 count.

    Example:
        >>> import torch
        >>> target = torch.tensor([2.5, 5.0, 4.0, 8.0])
        >>> preds = torch.tensor([3.0, 5.0, 2.5, 7.0])
        >>> mean_squared_log_error = MeanSquaredLogError(device="cpu")
        >>> round(float(mean_squared_log_error(preds, target)), 4)
        0.0397
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
        self.add_state("sum_squared_log_error", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
        self.sum_squared_log_error = self.sum_squared_log_error + sum_squared_log_error
        self.total = self.total + n_obs

    def compute(self) -> Tensor:
        return _mean_squared_log_error_compute(self.sum_squared_log_error, self.total)
