"""AveragePrecision module: exact average precision over every prediction seen.

Counterpart of ``metrics_tpu/classification/average_precision.py`` in its exact
mode; the sketch modes (``approx=``) raise ``NotImplementedError``.
"""
from typing import Any, Callable, List, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.classification._curve_base import _ExactCurveMetric, check_approx
from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute,
    _average_precision_update,
)
from metrics_tpu_torch.parallel.buffer import as_values


class AveragePrecision(_ExactCurveMetric):
    """Average precision over all data seen.

    Example (binary):
        >>> import torch
        >>> pred = torch.tensor([0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> average_precision = AveragePrecision(pos_label=1, device="cpu")
        >>> float(average_precision(pred, target))
        1.0
    """

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        capacity: Optional[int] = None,
        approx: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        check_approx(approx, ("sketch", "qsketch"))
        super().__init__(num_classes, pos_label, compute_on_step, dist_sync_on_step, process_group, dist_sync_fn,
                         capacity, device)

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target, num_classes, pos_label = _average_precision_update(
            preds, target, self.num_classes, self.pos_label
        )
        self._append("preds", preds)
        self._append("target", target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(self) -> Union[List[Tensor], Tensor]:
        return _average_precision_compute(
            as_values(self.preds), as_values(self.target), self.num_classes, self.pos_label
        )
