"""RelativeSquaredError module. Counterpart of ``metrics_tpu/regression/relative_squared.py``.

RSE = ``sum (t - p)^2 / sum (t - mean t)^2`` over the whole epoch. The
denominator needs the epoch's mean, so the states are raw moments (squared
error, sum t, sum t^2, count), all ``"sum"``, and the denominator is
``sum t^2 - (sum t)^2 / n`` at compute. ``num_outputs`` keeps per-column
moments; ``squared=False`` returns the root. The count is float32, as the
JAX package's.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import upcast_accum


class RelativeSquaredError(Metric):
    r"""Accumulated relative squared error (optionally rooted).

    Example:
        >>> import torch
        >>> metric = RelativeSquaredError(device="cpu")
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> round(float(metric(preds, target)), 4)
        0.0514
    """

    def __init__(
        self,
        num_outputs: int = 1,
        squared: bool = True,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, dist_sync_fn=dist_sync_fn, device=device)
        if not isinstance(num_outputs, int) or num_outputs < 1:
            raise ValueError(f"`num_outputs` must be a positive int, got {num_outputs!r}")
        self.num_outputs = num_outputs
        self.squared = squared
        for name in ("sum_sq_error", "sum_target", "sum_sq_target"):
            self.add_state(name, default=torch.zeros(num_outputs, dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        _check_same_shape(preds, target)
        preds, target = upcast_accum(preds), upcast_accum(target)
        if self.num_outputs == 1:
            if preds.ndim == 2 and preds.shape[1] == 1:
                preds, target = preds[:, 0], target[:, 0]
            if preds.ndim != 1:
                raise ValueError(f"Expected 1-D inputs (or (N, 1)) with num_outputs=1, got {tuple(preds.shape)}")
            preds, target = preds[:, None], target[:, None]
        elif preds.ndim != 2 or preds.shape[1] != self.num_outputs:
            raise ValueError(f"Expected (N, {self.num_outputs}) inputs, got {tuple(preds.shape)}")
        self.sum_sq_error = self.sum_sq_error + torch.sum((target - preds) ** 2, dim=0)
        self.sum_target = self.sum_target + torch.sum(target, dim=0)
        self.sum_sq_target = self.sum_sq_target + torch.sum(target**2, dim=0)
        self.total = self.total + target.shape[0]

    def compute(self) -> Tensor:
        n = torch.clamp_min(self.total, 1.0)
        denom = self.sum_sq_target - self.sum_target**2 / n
        positive = denom > 0
        rse = torch.where(positive, self.sum_sq_error / torch.where(positive, denom, torch.ones_like(denom)),
                          torch.full_like(denom, float("nan")))
        if not self.squared:
            rse = torch.sqrt(rse)
        return torch.mean(rse)  # one scalar, the mean over outputs, as the reference
