"""Accuracy module.

Counterpart of ``metrics_tpu/classification/accuracy.py``: ``correct`` /
``total`` int64 "sum" states.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.accuracy import _accuracy_compute, _accuracy_update


class Accuracy(Metric):
    r"""Fraction of correctly classified samples, accumulated over batches.

    Example:
        >>> import torch
        >>> target = torch.tensor([0, 1, 2, 3])
        >>> preds = torch.tensor([0, 2, 1, 3])
        >>> accuracy = Accuracy(device="cpu")
        >>> float(accuracy(preds, target))
        0.5
    """

    # compute-group key: two Accuracy instances with the same thresholding
    # config share one update delta inside a MetricCollection
    _GROUP_UPDATE_ATTRS = ("threshold", "top_k", "subset_accuracy")

    def __init__(
        self,
        threshold: float = 0.5,
        top_k: Optional[int] = None,
        subset_accuracy: bool = False,
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

        self.add_state("correct", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

        if not 0 < threshold < 1:
            raise ValueError(f"The `threshold` should be a float in the (0,1) interval, got {threshold}")

        if top_k is not None and (not isinstance(top_k, int) or top_k <= 0):
            raise ValueError(f"The `top_k` should be an integer larger than 0, got {top_k}")

        self.threshold = threshold
        self.top_k = top_k
        self.subset_accuracy = subset_accuracy

    def update(self, preds: Tensor, target: Tensor) -> None:
        correct, total = _accuracy_update(preds, target, self.threshold, self.top_k, self.subset_accuracy)
        self.correct = self.correct + correct
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _accuracy_compute(self.correct, self.total)
