"""ConfusionMatrix module.

Counterpart of ``metrics_tpu/classification/confusion_matrix.py``: a
``(C, C)`` int64 "sum" state.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.confusion_matrix import (
    _confusion_matrix_compute,
    _confusion_matrix_update,
)


class ConfusionMatrix(Metric):
    """Accumulate a (C, C) confusion matrix over batches.

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> confmat = ConfusionMatrix(num_classes=2, device="cpu")
        >>> confmat(preds, target)
        tensor([[2., 0.],
                [1., 1.]])
    """

    # compute-group key: ``normalize`` is compute-only, so a raw and a
    # normalized ConfusionMatrix (and IoU) over the same classes share one update
    _GROUP_UPDATE_ATTRS = ("num_classes", "threshold")

    def __init__(
        self,
        num_classes: int,
        normalize: Optional[str] = None,
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
        self.normalize = normalize
        self.threshold = threshold

        allowed_normalize = ("true", "pred", "all", "none", None)
        if self.normalize not in allowed_normalize:
            raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")

        zeros = torch.zeros((num_classes, num_classes), dtype=torch.int64)
        self.add_state("confmat", default=zeros, dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.confmat = self.confmat + _confusion_matrix_update(preds, target, self.num_classes, self.threshold)

    def compute(self) -> Tensor:
        return _confusion_matrix_compute(self.confmat, self.normalize)
