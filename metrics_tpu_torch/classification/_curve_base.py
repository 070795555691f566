"""Shared constructor and sketch plane of the curve metrics (AUROC, AveragePrecision,
ROC, PrecisionRecallCurve).

The exact mode (``approx=None``, the default) keeps two cat states, ``preds``
and ``target``. ``approx="sketch"`` keeps one constant-memory
:class:`~metrics_tpu_torch.parallel.sketch.HistogramSketch` ``hist`` of
``num_bins`` score bins per class over ``sketch_range``; ``approx="qsketch"``
(AUROC and AveragePrecision) bins on the log-bucketed grid of
:mod:`~metrics_tpu_torch.parallel.qsketch` (relative accuracy ``alpha``), with
no range to choose. A sketch update is one scatter; the sync is one
``all_reduce`` in the int64 sum bucket. Config-equal sketch members of
different classes share one compute group: one scatter a step serves them all.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.parallel.qsketch import (
    QSKETCH_CURVE_ALPHA,
    QuantileSketch,
    qsketch_curve_group_key,
    qsketch_curve_spec,
    qsketch_curve_update,
)
from metrics_tpu_torch.parallel.sketch import (
    HistogramSketch,
    canonicalize_approx,
    curve_sketch_group_key,
    curve_sketch_spec,
    sketch_curve_update,
    sketch_thresholds,
)
from metrics_tpu_torch.utils.data import device_constant
from metrics_tpu_torch.utils.prints import rank_zero_warn_once


class _CurveMetric(Metric):
    """A curve metric over every prediction seen (``preds`` / ``target`` cat
    states: lists, or PaddedBuffers with ``capacity``) or over a sketch
    (``hist``). Subclasses name the sketch modes they take and the warning of
    their exact mode."""

    _APPROX_MODES: Tuple[str, ...] = ("sketch",)
    _EXACT_WARNING = ""

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        capacity: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
        approx: Optional[str] = None,
        num_bins: int = 2048,
        sketch_range: Tuple[float, float] = (0.0, 1.0),
        alpha: float = QSKETCH_CURVE_ALPHA,
    ):
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
            capacity=capacity,
        )
        self.num_classes = num_classes
        self.pos_label = pos_label
        self.approx = canonicalize_approx(approx, allowed=type(self)._APPROX_MODES)
        self.num_bins = num_bins
        self.sketch_range = tuple(sketch_range)
        self.alpha = float(alpha)

    def _add_states(self) -> None:
        """The states of the chosen mode (after the subclass validated its arguments)."""
        if self.approx == "qsketch":
            self.add_state("hist", default=qsketch_curve_spec(self.alpha, self.num_classes), dist_reduce_fx="sum")
        elif self.approx == "sketch":
            spec = curve_sketch_spec(self.num_bins, self.num_classes, *self.sketch_range)
            self.add_state("hist", default=spec, dist_reduce_fx="sum")
        else:
            self.add_state("preds", default=[], dist_reduce_fx=None)
            self.add_state("target", default=[], dist_reduce_fx=None)
            rank_zero_warn_once(type(self)._EXACT_WARNING)

    def _sketch_update(self, preds: Tensor, target: Tensor) -> None:
        """Fold a batch into the sketch: the update every sketch-mode member runs."""
        pos_label = 1 if self.pos_label is None else self.pos_label
        if self.approx == "qsketch":
            spec = self._defaults["hist"]
            self.hist = QuantileSketch(qsketch_curve_update(
                self.hist.counts, preds, target, spec.alpha, spec.min_value, spec.max_value, pos_label))
        else:
            self.hist = HistogramSketch(sketch_curve_update(self.hist.counts, preds, target, *self.sketch_range,
                                                            pos_label))

    def _sketch_thresholds(self) -> Tensor:
        """The ``num_bins + 1`` thresholds of the sketch grid on ``self.device`` (a copy of a cached constant)."""
        lo, hi = self.sketch_range
        return device_constant(("sketch thresholds", self.num_bins, lo, hi), self.device,
                               lambda: sketch_thresholds(self.num_bins, lo, hi), torch.float32).clone()

    def _states_own_sync(self) -> bool:
        # ROC and PrecisionRecallCurve: their padded curves run on the ring over row-sharded
        # states (AUROC and AveragePrecision override this with their own dispatch's test)
        from metrics_tpu_torch.parallel.sharded_dispatch import curve_applicable

        return curve_applicable(self) is not None

    def _group_fingerprint(self) -> Optional[Any]:
        # sketch-mode curve metrics share one update (the scatter of
        # sketch_curve_update / qsketch_curve_update) across the curve family:
        # equal sketch config means one compute-group delta serves them all
        if self.approx == "qsketch":
            return qsketch_curve_group_key(self)
        if self.approx == "sketch":
            return curve_sketch_group_key(self)
        return super()._group_fingerprint()
