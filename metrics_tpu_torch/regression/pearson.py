"""PearsonCorrcoef module. Counterpart of ``metrics_tpu/regression/pearson.py``.

The state is one float32 ``(6,)`` co-moment vector whose reduction is
:func:`~metrics_tpu_torch.functional.regression.pearson.chan_fold`, marked
``associative``: the one-delta ``forward`` folds a batch into the accumulator
with it (one update a step), and a rank sync gathers the ``(world, 6)`` stack
and folds it. An int64 ``n_total`` keeps the exact count beside the float32
``n`` of the vector.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.pearson import (
    batch_comoments,
    chan_fold,
    chan_merge,
    comoments_corrcoef,
)
from metrics_tpu_torch.utils.prints import rank_zero_warn


class PearsonCorrcoef(Metric):
    r"""Accumulated Pearson correlation coefficient; ``nan`` when either input
    has zero variance (scipy's convention).

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> pearson = PearsonCorrcoef(device="cpu")
        >>> round(float(pearson(preds, target)), 4)
        0.9849
    """

    # float32 integers stop growing at 2**24: past it the merge weights nb / n use a frozen n
    _F32_COUNT_SATURATION = 2**24

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
        self.add_state("comoments", default=torch.zeros(6, dtype=torch.float32), dist_reduce_fx=chan_fold)
        self.add_state("n_total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.comoments = chan_merge(self.comoments, batch_comoments(preds, target))
        self.n_total = self.n_total + preds.shape[0]

    def _host_warnings(self) -> None:
        # from the host-side bound of samples seen: no device read
        if self._count_bound >= self._F32_COUNT_SATURATION:
            rank_zero_warn(
                f"{self.__class__.__name__} has processed ~{self._count_bound} samples; the float32"
                " sample count carried in the co-moment state saturates at 2^24, so further"
                " accumulation behaves as a ~16.7M-sample moving window rather than a true"
                " running mean.",
                UserWarning,
            )

    def compute(self) -> Tensor:
        return comoments_corrcoef(self.comoments)
