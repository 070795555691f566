"""ROC module: the exact receiver operating characteristic over every prediction seen.

Counterpart of ``metrics_tpu/classification/roc.py`` in its exact mode; the
sketch mode (``approx=``) raises ``NotImplementedError``.
"""
from typing import Any, Callable, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.classification._curve_base import _ExactCurveMetric, check_approx
from metrics_tpu_torch.classification._padded_curves import padded_curve_compute
from metrics_tpu_torch.functional.classification.roc import _roc_compute, _roc_update
from metrics_tpu_torch.parallel.buffer import as_values


class ROC(_ExactCurveMetric):
    """Receiver operating characteristic over all data seen.

    With a ``capacity`` the states are PaddedBuffers and ``compute()`` returns
    static-shape padded curves, ``(fpr, tpr, thresholds, count)``: the curve in
    the first ``count`` positions and the final point repeated after
    (multiclass / multilabel: a leading class axis and per-class counts).
    Without it the dynamic 3-tuple is returned.

    Example (binary):
        >>> import torch
        >>> pred = torch.tensor([0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> roc = ROC(pos_label=1, device="cpu")
        >>> fpr, tpr, thresholds = roc(pred, target)
        >>> fpr
        tensor([0., 0., 0., 0., 1.])
        >>> thresholds
        tensor([4, 3, 2, 1, 0])
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
        preds, target, num_classes, pos_label = _roc_update(preds, target, self.num_classes, self.pos_label)
        self._append("preds", preds)
        self._append("target", target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(self) -> Union[Tuple[Tensor, ...], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        padded = padded_curve_compute(self, "roc")
        if padded is not None:
            return padded
        return _roc_compute(as_values(self.preds), as_values(self.target), self.num_classes, self.pos_label)
