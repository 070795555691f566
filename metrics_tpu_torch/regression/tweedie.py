"""TweedieDevianceScore module. Counterpart of ``metrics_tpu/regression/tweedie.py``."""
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.streaming import SumCountMetric
from metrics_tpu_torch.functional.regression.tweedie import _check_power, _tweedie_update


class TweedieDevianceScore(SumCountMetric):
    r"""Accumulated mean Tweedie deviance (``power`` 0 / 1 / 2 / (1, 2)).

    Example:
        >>> import torch
        >>> metric = TweedieDevianceScore(power=1, device="cpu")
        >>> round(float(metric(torch.tensor([2.0, 0.5, 1.0]), torch.tensor([1.5, 1.0, 1.0]))), 4)
        0.1744
    """

    def __init__(
        self,
        power: float = 0.0,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, dist_sync_fn=dist_sync_fn, device=device)
        _check_power(power)
        self.power = power

    def _update_stats(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Any]:
        return _tweedie_update(preds, target, self.power)
