"""AUROC module: exact area under the ROC curve over every prediction seen.

Counterpart of ``metrics_tpu/classification/auroc.py`` in its exact mode; the
sketch modes (``approx=``) raise ``NotImplementedError``.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.classification._curve_base import _ExactCurveMetric, check_approx
from metrics_tpu_torch.functional.classification.auroc import _auroc_compute, _auroc_update
from metrics_tpu_torch.parallel.buffer import as_values
from metrics_tpu_torch.utils.checks import _input_format_classification


class AUROC(_ExactCurveMetric):
    """Area under the ROC curve, over all data seen.

    Example (binary):
        >>> import torch
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> auroc = AUROC(pos_label=1, device="cpu")
        >>> float(auroc(preds, target))
        0.5
    """

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
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
        self.average = average
        self.max_fpr = max_fpr

        allowed_average = (None, "macro", "weighted", "micro")
        if self.average not in allowed_average:
            raise ValueError(
                f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
            )
        if self.max_fpr is not None:
            if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
                raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")
        self.mode = None

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target, mode = _auroc_update(preds, target)
        self._append("preds", preds)
        self._append("target", target)
        if self.mode is not None and self.mode != mode:
            raise ValueError(
                "The mode of data (binary, multi-label, multi-class) should be constant, but changed"
                f" between batches from {self.mode} to {mode}"
            )
        self.mode = mode

    def compute(self) -> Tensor:
        preds, target = as_values(self.preds), as_values(self.target)
        mode = self.mode
        if mode is None:  # a rank with no update of its own computes from the gathered states
            _, _, mode = _input_format_classification(preds, target, validate=False)
        return _auroc_compute(preds, target, mode, self.num_classes, self.pos_label, self.average, self.max_fpr)
