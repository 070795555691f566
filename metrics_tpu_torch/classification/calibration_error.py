"""CalibrationError module.

Counterpart of ``metrics_tpu/classification/calibration_error.py``: three
``(n_bins,)`` "sum" states (float32 confidence and accuracy sums, int64
counts), so the epoch value is exact in O(bins) memory and syncs with one
reduction per dtype.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.calibration_error import (
    _NORMS,
    _calibration_compute,
    _calibration_update,
)


class CalibrationError(Metric):
    r"""Accumulated top-1 calibration error (ECE / RMSCE / MCE).

    Args:
        n_bins: number of uniform confidence bins over [0, 1].
        norm: "l1" (ECE, default), "l2" (RMS), or "max" (MCE).

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.9, 0.1], [0.6, 0.4], [0.2, 0.8]])
        >>> target = torch.tensor([0, 1, 1])
        >>> ce = CalibrationError(n_bins=4, device="cpu")
        >>> round(float(ce(preds, target)), 4)
        0.3
    """

    def __init__(
        self,
        n_bins: int = 15,
        norm: str = "l1",
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
        if norm not in _NORMS:
            raise ValueError(f"`norm` must be one of {_NORMS}, got {norm!r}")
        if not isinstance(n_bins, int) or n_bins <= 0:
            raise ValueError(f"`n_bins` must be a positive integer, got {n_bins!r}")
        self.n_bins = n_bins
        self.norm = norm
        for name in ("conf_sum", "acc_sum"):
            self.add_state(name, default=torch.zeros((n_bins,), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("count", default=torch.zeros((n_bins,), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        conf_sum, acc_sum, count = _calibration_update(preds, target, self.n_bins)
        self.conf_sum = self.conf_sum + conf_sum
        self.acc_sum = self.acc_sum + acc_sum
        self.count = self.count + count

    def compute(self) -> Tensor:
        return _calibration_compute(self.conf_sum, self.acc_sum, self.count, self.norm)
