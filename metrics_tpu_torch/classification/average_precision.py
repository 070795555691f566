"""AveragePrecision module: average precision over every prediction seen, exact or sketched.

Counterpart of ``metrics_tpu/classification/average_precision.py``.
"""
from typing import Any, Callable, List, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.classification._curve_base import _CurveMetric
from metrics_tpu_torch.functional.classification.average_precision import (
    _average_precision_compute,
    _average_precision_update,
)
from metrics_tpu_torch.parallel.buffer import as_values
from metrics_tpu_torch.parallel.qsketch import QSKETCH_CURVE_ALPHA
from metrics_tpu_torch.parallel.sketch import average_precision_from_histogram, curve_collision_bound


class AveragePrecision(_CurveMetric):
    """Average precision over all data seen.

    ``approx="sketch"`` / ``"qsketch"``: the step integral over the sketched PR
    curve (per class for the ``(C, 2, B)`` layouts), from a constant-memory
    histogram synced with one ``all_reduce``; :meth:`collision_bound` reports
    the unresolved cross-pair fraction.

    Example (binary):
        >>> import torch
        >>> pred = torch.tensor([0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> average_precision = AveragePrecision(pos_label=1, device="cpu")
        >>> float(average_precision(pred, target))
        1.0
    """

    _APPROX_MODES = ("sketch", "qsketch")
    _EXACT_WARNING = (
        "Metric `AveragePrecision` stores every prediction and target in an"
        " O(samples) buffer state, so memory and sync traffic grow with the"
        " dataset. Construct with `approx=\"qsketch\"` for a constant-memory"
        " AUTO-RANGED histogram sketch (no sketch_range assumption on raw"
        " scores) that syncs with one all_reduce, `approx=\"sketch\"` for the"
        " fixed-grid variant, or use `BinnedAveragePrecision`; exact"
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
        alpha: float = QSKETCH_CURVE_ALPHA,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(num_classes, pos_label, compute_on_step, dist_sync_on_step, process_group, dist_sync_fn,
                         capacity, device, approx, num_bins, sketch_range, alpha)
        self._add_states()

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.approx is not None:
            self._sketch_update(preds, target)
            return
        preds, target, num_classes, pos_label = _average_precision_update(
            preds, target, self.num_classes, self.pos_label
        )
        self._append("preds", preds)
        self._append("target", target)
        self.num_classes = num_classes
        self.pos_label = pos_label

    def collision_bound(self) -> Tensor:
        """Certificate of the sketch modes: the fraction of positive / negative
        cross pairs colliding in one bucket, which drives the step integral's
        deviation (either grid)."""
        if self.approx is None:
            raise ValueError("collision_bound() needs approx='sketch' or 'qsketch'")
        return curve_collision_bound(self.hist.counts)

    def _states_own_sync(self) -> bool:
        from metrics_tpu_torch.parallel.sharded_dispatch import _AP_FALLBACK, average_precision_applicable, owns_sync

        return owns_sync(self, average_precision_applicable(self), _AP_FALLBACK, "preds", "target")

    def compute(self) -> Union[List[Tensor], Tensor]:
        if self.approx is not None:
            return average_precision_from_histogram(self.hist.counts)
        from metrics_tpu_torch.parallel.sharded_dispatch import average_precision_sharded

        sharded = average_precision_sharded(self)  # row-sharded epoch states: the exact ring
        if sharded is not None:
            return sharded
        return _average_precision_compute(
            as_values(self.preds), as_values(self.target), self.num_classes, self.pos_label
        )
