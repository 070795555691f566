"""KLDivergence module: two scalar ``"sum"`` states. Counterpart of
``metrics_tpu/regression/kl_divergence.py``."""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.kl_divergence import _kld_update


class KLDivergence(Metric):
    r"""Accumulated KL(p || q) over pairs of distributions.

    Example:
        >>> import torch
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1/3, 1/3, 1/3]])
        >>> kld = KLDivergence(device="cpu")
        >>> round(float(kld(p, q)), 4)
        0.0853
    """

    def __init__(
        self,
        log_prob: bool = False,
        reduction: str = "mean",
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, dist_sync_fn=dist_sync_fn, device=device)
        if reduction not in ("mean", "sum"):
            raise ValueError(f"Expected reduction to be 'mean' or 'sum', got {reduction}")
        self.log_prob = log_prob
        self.reduction = reduction
        self.add_state("measure_sum", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, p: Tensor, q: Tensor) -> None:
        total, n = _kld_update(p, q, self.log_prob)
        self.measure_sum = self.measure_sum + total
        self.total = self.total + n

    def compute(self) -> Tensor:
        if self.reduction == "sum":
            return self.measure_sum
        return self.measure_sum / torch.clamp_min(self.total.to(torch.float32), 1.0)
