"""HingeLoss module.

Counterpart of ``metrics_tpu/classification/hinge.py``, on the port's
:class:`~metrics_tpu_torch.core.streaming.SumCountMetric`.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.streaming import SumCountMetric
from metrics_tpu_torch.functional.classification.hinge import _hinge_update


class HingeLoss(SumCountMetric):
    r"""Accumulated mean (squared) hinge loss, as sklearn computes it.

    Binary inputs are ``(N,)`` decision values with ``{0, 1}`` (or
    ``{-1, +1}``) targets; multiclass ``(N, C)`` scores use the
    Crammer-Singer margin.

    Example:
        >>> import torch
        >>> metric = HingeLoss(device="cpu")
        >>> round(float(metric(torch.tensor([0.5, -1.5, 2.0]), torch.tensor([1, 0, 1]))), 4)
        0.1667
    """

    def __init__(
        self,
        squared: bool = False,
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
        self.squared = squared

    def _update_stats(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Any]:
        return _hinge_update(preds, target, self.squared)
