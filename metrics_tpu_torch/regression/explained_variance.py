"""ExplainedVariance module: five float32 ``"sum"`` moments, O(num_outputs) state.

Counterpart of ``metrics_tpu/regression/explained_variance.py``. The count
``n_obs`` is float32, as the JAX package's: exact up to 2**24 samples, and
past it exact only while the batches keep it on the float32 grid.
"""
from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.explained_variance import (
    _explained_variance_compute,
    _explained_variance_update,
)
from metrics_tpu_torch.functional.regression.r2score import _MULTIOUTPUTS


class ExplainedVariance(Metric):
    """Accumulated explained variance.

    Example:
        >>> import torch
        >>> target = torch.tensor([3, -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> explained_variance = ExplainedVariance(device="cpu")
        >>> round(float(explained_variance(preds, target)), 4)
        0.9572
    """

    def __init__(
        self,
        multioutput: str = "uniform_average",
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, dist_sync_fn=dist_sync_fn, device=device)
        if multioutput not in _MULTIOUTPUTS:
            raise ValueError(
                f"Invalid input to argument `multioutput`. Choose one of the following: {_MULTIOUTPUTS}"
            )
        self.multioutput = multioutput
        for name in ("sum_error", "sum_squared_error", "sum_target", "sum_squared_target", "n_obs"):
            self.add_state(name, default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        n_obs, sum_error, sum_squared_error, sum_target, sum_squared_target = _explained_variance_update(preds, target)
        self.n_obs = self.n_obs + n_obs
        self.sum_error = self.sum_error + sum_error
        self.sum_squared_error = self.sum_squared_error + sum_squared_error
        self.sum_target = self.sum_target + sum_target
        self.sum_squared_target = self.sum_squared_target + sum_squared_target

    def compute(self) -> Union[Tensor, Sequence[Tensor]]:
        return _explained_variance_compute(self.n_obs, self.sum_error, self.sum_squared_error, self.sum_target,
                                           self.sum_squared_target, self.multioutput)
