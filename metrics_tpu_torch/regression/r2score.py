"""R2Score module. Counterpart of ``metrics_tpu/regression/r2score.py``: three
float32 ``(num_outputs,)`` moments and an int64 count, all ``"sum"``."""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.r2score import (
    _MULTIOUTPUTS,
    _check_adjusted,
    _r2score_compute,
    _r2score_update,
)


class R2Score(Metric):
    r"""Accumulated R^2 (coefficient of determination).

    Example:
        >>> import torch
        >>> target = torch.tensor([3, -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> r2score = R2Score(device="cpu")
        >>> round(float(r2score(preds, target)), 4)
        0.9486
        >>> target = torch.tensor([[0.5, 1], [-1, 1], [7, -6]])
        >>> preds = torch.tensor([[0., 2], [-1, 2], [8, -5]])
        >>> r2score = R2Score(num_outputs=2, multioutput='raw_values', device="cpu")
        >>> [round(float(v), 4) for v in r2score(preds, target)]
        [0.9654, 0.9082]
    """

    def __init__(
        self,
        num_outputs: int = 1,
        adjusted: int = 0,
        multioutput: str = "uniform_average",
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, dist_sync_fn=dist_sync_fn, device=device)
        self.num_outputs = num_outputs
        _check_adjusted(adjusted)
        self.adjusted = adjusted
        if multioutput not in _MULTIOUTPUTS:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {_MULTIOUTPUTS}"
            )
        self.multioutput = multioutput
        for name in ("sum_squared_error", "sum_error", "residual"):
            self.add_state(name, default=torch.zeros(num_outputs, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_error, sum_error, residual, total = _r2score_update(preds, target)
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.sum_error = self.sum_error + sum_error
        self.residual = self.residual + residual
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _r2score_compute(self.sum_squared_error, self.sum_error, self.residual, self.total, self.adjusted,
                                self.multioutput)
