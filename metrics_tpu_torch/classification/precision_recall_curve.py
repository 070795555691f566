"""PrecisionRecallCurve module: exact precision / recall pairs over every prediction seen.

Counterpart of ``metrics_tpu/classification/precision_recall_curve.py`` in its
exact mode; the sketch mode (``approx=``) raises ``NotImplementedError``.
"""
from typing import Any, Callable, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.classification._curve_base import _ExactCurveMetric, check_approx
from metrics_tpu_torch.classification._padded_curves import padded_curve_compute
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.parallel.buffer import as_values


class PrecisionRecallCurve(_ExactCurveMetric):
    """Precision / recall pairs at every distinct threshold, over all data seen.

    With a ``capacity`` the states are PaddedBuffers and ``compute()`` returns
    static-shape padded curves, ``(precision, recall, thresholds, count)``:
    ``count`` thresholds are valid, ``precision`` / ``recall`` hold
    ``count + 1`` points, and the tails repeat the final entries.

    Example (binary):
        >>> import torch
        >>> pred = torch.tensor([0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> pr_curve = PrecisionRecallCurve(pos_label=1, device="cpu")
        >>> precision, recall, thresholds = pr_curve(pred, target)
        >>> precision
        tensor([0.6667, 0.5000, 0.0000, 1.0000])
        >>> thresholds
        tensor([1, 2, 3])
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
        check_approx(approx, ("sketch",))
        super().__init__(num_classes, pos_label, compute_on_step, dist_sync_on_step, process_group, dist_sync_fn,
                         capacity, device)

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target, num_classes, pos_label = _precision_recall_curve_update(
            preds, target, self.num_classes, self.pos_label
        )
        self._append("preds", preds)
        self._append("target", target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(self) -> Union[Tuple[Tensor, ...], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        padded = padded_curve_compute(self, "prc")
        if padded is not None:
            return padded
        return _precision_recall_curve_compute(
            as_values(self.preds), as_values(self.target), self.num_classes, self.pos_label
        )
