"""AUC module: the area under an accumulated (x, y) curve.

Counterpart of ``metrics_tpu/classification/auc.py``.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.auc import _auc_compute, _auc_update
from metrics_tpu_torch.parallel.buffer import as_values
from metrics_tpu_torch.utils.prints import rank_zero_warn_once


class AUC(Metric):
    """Area under an accumulated (x, y) curve, by the trapezoidal rule."""

    def __init__(
        self,
        reorder: bool = False,
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
        self.reorder = reorder
        self.add_state("x", default=[], dist_reduce_fx=None)
        self.add_state("y", default=[], dist_reduce_fx=None)
        rank_zero_warn_once(
            "Metric `AUC` stores every (x, y) point in an O(samples) buffer"
            " state, so memory and sync traffic grow with the dataset. For"
            " score curves, prefer the constant-memory sketch modes of the"
            " curve metrics — `AUROC(approx=\"qsketch\")` is the RANGE-FREE"
            " fix (auto-ranged log-bucketed grid, no sketch_range assumption"
            " on raw scores); `AUROC(approx=\"sketch\")` / `BinnedAUROC`"
            " integrate on a fixed grid — all syncing with one all_reduce."
        )

    def update(self, x: Tensor, y: Tensor) -> None:
        x, y = _auc_update(x, y)
        self._append("x", x)
        self._append("y", y)

    def compute(self) -> Tensor:
        return _auc_compute(as_values(self.x), as_values(self.y), reorder=self.reorder)
