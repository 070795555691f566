"""PrecisionRecallCurve module: precision / recall pairs over every prediction seen, exact or sketched.

Counterpart of ``metrics_tpu/classification/precision_recall_curve.py``.
"""
from typing import Any, Callable, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.classification._curve_base import _CurveMetric
from metrics_tpu_torch.classification._padded_curves import padded_curve_compute
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.parallel.buffer import as_values
from metrics_tpu_torch.parallel.sketch import precision_recall_from_histogram


class PrecisionRecallCurve(_CurveMetric):
    """Precision / recall pairs at every distinct threshold, over all data seen.

    With a ``capacity`` the states are PaddedBuffers and ``compute()`` returns
    static-shape padded curves, ``(precision, recall, thresholds, count)``:
    ``count`` thresholds are valid, ``precision`` / ``recall`` hold
    ``count + 1`` points, and the tails repeat the final entries.
    ``approx="sketch"`` evaluates the curve on the ``num_bins + 1`` threshold
    grid (the bin edges and the (precision = 1, recall = 0) terminal anchor)
    from a constant-memory histogram.

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

    _EXACT_WARNING = (
        "Metric `PrecisionRecallCurve` stores every prediction and target in"
        " an O(samples) buffer state, so memory and sync traffic grow with"
        " the dataset. Construct with `approx=\"sketch\"` for a"
        " constant-memory fixed-grid curve (one all_reduce to sync), or use"
        " `BinnedPrecisionRecallCurve`; for the scalar summary on raw"
        " un-sigmoided scores, `AveragePrecision(approx=\"qsketch\")` is"
        " the RANGE-FREE fix (auto-ranged log-bucketed grid). Exact"
        " buffers remain the default."
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
        preds, target, num_classes, pos_label = _precision_recall_curve_update(
            preds, target, self.num_classes, self.pos_label
        )
        self._append("preds", preds)
        self._append("target", target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def compute(self) -> Union[Tuple[Tensor, ...], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
        if self.approx is not None:
            precision, recall = precision_recall_from_histogram(self.hist.counts)
            return precision, recall, self._sketch_thresholds()
        padded = padded_curve_compute(self, "prc")
        if padded is not None:
            return padded
        return _precision_recall_curve_compute(
            as_values(self.preds), as_values(self.target), self.num_classes, self.pos_label
        )
