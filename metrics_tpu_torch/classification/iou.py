"""IoU module (a ConfusionMatrix subclass).

Counterpart of ``metrics_tpu/classification/iou.py``. It keeps
ConfusionMatrix's update, so the two share one compute group.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix
from metrics_tpu_torch.functional.classification.iou import _iou_from_confmat


class IoU(ConfusionMatrix):
    r"""Jaccard index accumulated over batches via the confusion matrix.

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> iou = IoU(num_classes=2, device="cpu")
        >>> round(float(iou(preds, target)), 4)
        0.5833
    """

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        absent_score: float = 0.0,
        threshold: float = 0.5,
        reduction: str = "elementwise_mean",
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(
            num_classes=num_classes,
            normalize=None,
            threshold=threshold,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.reduction = reduction
        self.ignore_index = ignore_index
        self.absent_score = absent_score

    def compute(self) -> Tensor:
        return _iou_from_confmat(self.confmat, self.num_classes, self.ignore_index, self.absent_score, self.reduction)


class JaccardIndex(IoU):
    r"""Alias of :class:`IoU` under its set-theory name.

    Example:
        >>> import torch
        >>> jaccard = JaccardIndex(num_classes=2, device="cpu")
        >>> round(float(jaccard(torch.tensor([0, 1, 0, 0]), torch.tensor([1, 1, 0, 0]))), 4)
        0.5833
    """
