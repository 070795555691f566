"""PSNR module. Counterpart of ``metrics_tpu/regression/psnr.py``.

``dim=None``: a float32 sum of squared errors and an int64 count, ``"sum"``
states. With ``dim``: list states of the per-slice sums and counts, gathered
across ranks at ``compute()``. Without ``data_range``: the running ``min`` /
``max`` of the target as ``"min"`` / ``"max"`` states, both starting at 0 as
the reference's do.
"""
from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.psnr import _psnr_compute, _psnr_update
from metrics_tpu_torch.utils.data import dim_zero_cat
from metrics_tpu_torch.utils.prints import rank_zero_warn_once


class PSNR(Metric):
    r"""Accumulated peak signal-to-noise ratio.

    Example:
        >>> import torch
        >>> psnr = PSNR(data_range=8.0, device="cpu")
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> round(float(psnr(preds, target)), 4)
        11.0721
    """

    def __init__(
        self,
        data_range: Optional[float] = None,
        base: float = 10.0,
        reduction: str = "elementwise_mean",
        dim: Optional[Union[int, Tuple[int, ...]]] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, device=device)
        if dim is None and reduction != "elementwise_mean":
            rank_zero_warn_once(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
        if dim is None:
            self.add_state("sum_squared_error", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
            self.add_state("total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")
        else:
            self.add_state("sum_squared_error", default=[])
            self.add_state("total", default=[])
        if data_range is None:
            if dim is not None:
                raise ValueError("The `data_range` must be given when `dim` is not None.")
            self.data_range = None
            self.add_state("min_target", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="min")
            self.add_state("max_target", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="max")
        else:
            self.data_range = float(data_range)
        self.base = base
        self.reduction = reduction
        self.dim = tuple(dim) if isinstance(dim, Sequence) else dim

    def update(self, preds: Tensor, target: Tensor) -> None:
        sum_squared_error, n_obs = _psnr_update(preds, target, dim=self.dim)
        if self.dim is None:
            if self.data_range is None:
                self.min_target = torch.minimum(torch.min(target).to(torch.float32), self.min_target)
                self.max_target = torch.maximum(torch.max(target).to(torch.float32), self.max_target)
            self.sum_squared_error = self.sum_squared_error + sum_squared_error
            self.total = self.total + n_obs
        else:
            self._append("sum_squared_error", sum_squared_error)
            self._append("total", n_obs)

    def compute(self) -> Tensor:
        data_range = self.data_range if self.data_range is not None else self.max_target - self.min_target
        if self.dim is None:
            sum_squared_error, total = self.sum_squared_error, self.total
        else:
            sum_squared_error = dim_zero_cat([v.reshape(-1) for v in self.sum_squared_error])
            total = dim_zero_cat([v.reshape(-1) for v in self.total])
        return _psnr_compute(sum_squared_error, total, data_range, base=self.base, reduction=self.reduction)
