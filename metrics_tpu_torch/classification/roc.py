"""ROC module: the receiver operating characteristic over every prediction seen, exact or sketched.

Counterpart of ``metrics_tpu/classification/roc.py``.
"""
from typing import Any, Callable, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.classification._curve_base import _CurveMetric
from metrics_tpu_torch.classification._padded_curves import padded_curve_compute
from metrics_tpu_torch.functional.classification.roc import _roc_compute, _roc_update
from metrics_tpu_torch.parallel.buffer import as_values
from metrics_tpu_torch.parallel.sketch import roc_from_histogram


class ROC(_CurveMetric):
    """Receiver operating characteristic over all data seen.

    With a ``capacity`` the states are PaddedBuffers and ``compute()`` returns
    static-shape padded curves, ``(fpr, tpr, thresholds, count)``: the curve in
    the first ``count`` positions and the final point repeated after
    (multiclass / multilabel: a leading class axis and per-class counts).
    Without it the dynamic 3-tuple is returned. ``approx="sketch"`` evaluates
    the ROC on the ``num_bins + 1`` threshold grid (the bin edges and the (0, 0)
    terminal anchor) from a constant-memory histogram.

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

    _EXACT_WARNING = (
        "Metric `ROC` stores every prediction and target in an O(samples)"
        " buffer state, so memory and sync traffic grow with the dataset."
        " Construct with `approx=\"sketch\"` for a constant-memory"
        " fixed-grid curve (one all_reduce to sync), or use `BinnedROC`; for the"
        " scalar area on raw un-sigmoided scores, `AUROC(approx="
        "\"qsketch\")` is the RANGE-FREE fix (auto-ranged log-bucketed"
        " grid, no sketch_range assumption). Exact buffers remain the"
        " default."
    )

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
        num_bins: int = 2048,
        sketch_range: Tuple[float, float] = (0.0, 1.0),
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(num_classes, pos_label, compute_on_step, dist_sync_on_step, process_group, dist_sync_fn,
                         capacity, device, approx, num_bins, sketch_range)
        self._add_states()

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.approx is not None:
            self._sketch_update(preds, target)
            return
        preds, target, num_classes, pos_label = _roc_update(preds, target, self.num_classes, self.pos_label)
        self._append("preds", preds)
        self._append("target", target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(self) -> Union[Tuple[Tensor, ...], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        if self.approx is not None:
            fpr, tpr = roc_from_histogram(self.hist.counts)
            return fpr, tpr, self._sketch_thresholds()
        padded = padded_curve_compute(self, "roc")
        if padded is not None:
            return padded
        return _roc_compute(as_values(self.preds), as_values(self.target), self.num_classes, self.pos_label)
