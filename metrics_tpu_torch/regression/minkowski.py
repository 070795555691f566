"""LogCoshError / MinkowskiDistance modules. Counterpart of ``metrics_tpu/regression/minkowski.py``."""
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.core.streaming import SumCountMetric
from metrics_tpu_torch.functional.regression.minkowski import _log_cosh_update, _minkowski_update


class LogCoshError(SumCountMetric):
    r"""Accumulated mean log-cosh error.

    Example:
        >>> import torch
        >>> metric = LogCoshError(device="cpu")
        >>> round(float(metric(torch.tensor([0.5, 1.0, 2.5]), torch.tensor([0.0, 1.0, 2.0]))), 4)
        0.0801
    """

    def _update_stats(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Any]:
        return _log_cosh_update(preds, target)


class MinkowskiDistance(Metric):
    r"""Accumulated Minkowski distance ``(sum |p - t|^p)^(1/p)`` over all data
    seen; the p-th powers are the sum state.

    Example:
        >>> import torch
        >>> metric = MinkowskiDistance(p=2, device="cpu")
        >>> round(float(metric(torch.tensor([0.5, 1.0, 2.5]), torch.tensor([0.0, 1.0, 2.0]))), 4)
        0.7071
    """

    def __init__(
        self,
        p: float = 2.0,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, dist_sync_fn=dist_sync_fn, device=device)
        if not p >= 1:
            raise ValueError(f"`p` must be >= 1, got {p!r}")
        self.p = float(p)
        self.add_state("sum_pow", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.sum_pow = self.sum_pow + _minkowski_update(preds, target, self.p)

    def compute(self) -> Tensor:
        return self.sum_pow ** (1.0 / self.p)
