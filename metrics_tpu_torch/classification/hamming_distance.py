"""HammingDistance module.

Counterpart of ``metrics_tpu/classification/hamming_distance.py``:
``correct`` / ``total`` int64 "sum" states.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.hamming_distance import (
    _hamming_distance_compute,
    _hamming_distance_update,
)


class HammingDistance(Metric):
    r"""Average Hamming loss, accumulated over batches.

    Example:
        >>> import torch
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> hamming_distance = HammingDistance(device="cpu")
        >>> float(hamming_distance(preds, target))
        0.25
    """

    _GROUP_UPDATE_ATTRS = ("threshold",)

    def __init__(
        self,
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

        self.add_state("correct", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

        if not 0 < threshold < 1:
            raise ValueError(f"The `threshold` should be a float in the (0,1) interval, got {threshold}")
        self.threshold = threshold

    def update(self, preds: Tensor, target: Tensor) -> None:
        correct, total = _hamming_distance_update(preds, target, self.threshold)
        self.correct = self.correct + correct
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _hamming_distance_compute(self.correct, self.total)
