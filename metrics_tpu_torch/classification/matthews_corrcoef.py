"""MatthewsCorrcoef module.

Counterpart of ``metrics_tpu/classification/matthews_corrcoef.py``: a
``(C, C)`` int64 "sum" state. It declares no compute-group key, as in the
JAX package.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.matthews_corrcoef import (
    _matthews_corrcoef_compute,
    _matthews_corrcoef_update,
)


class MatthewsCorrcoef(Metric):
    r"""Matthews correlation coefficient, accumulated via the confusion matrix.

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> matthews_corrcoef = MatthewsCorrcoef(num_classes=2, device="cpu")
        >>> round(float(matthews_corrcoef(preds, target)), 4)
        0.5774
    """

    def __init__(
        self,
        num_classes: int,
        threshold: float = 0.5,
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
        self.num_classes = num_classes
        self.threshold = threshold

        zeros = torch.zeros((num_classes, num_classes), dtype=torch.int64)
        self.add_state("confmat", default=zeros, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.confmat = self.confmat + _matthews_corrcoef_update(preds, target, self.num_classes, self.threshold)

    def compute(self) -> Tensor:
        return _matthews_corrcoef_compute(self.confmat)
