"""ExactMatch module (subset accuracy).

Counterpart of ``metrics_tpu/classification/exact_match.py``. Its two
scalar "sum" states are float32, as in the JAX package: exact up to 2**24
samples.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.exact_match import _exact_match_compute, _exact_match_update


class ExactMatch(Metric):
    """Accumulated exact-match ratio: a sample is correct only when every
    position (all labels of a multilabel row, all elements of a multidim
    multiclass sample) agrees with the target.

    Example:
        >>> import torch
        >>> metric = ExactMatch(num_classes=3, device="cpu")
        >>> preds = torch.tensor([[0, 1], [2, 1]])
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> float(metric(preds, target))
        0.5
    """

    def __init__(
        self,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
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
        self.threshold = threshold
        self.num_classes = num_classes
        self.add_state("correct", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        correct, total = _exact_match_update(preds, target, self.threshold, self.num_classes)
        self.correct = self.correct + correct
        self.total = self.total + total

    def compute(self) -> Tensor:
        return _exact_match_compute(self.correct, self.total)
