"""The shared base of the rank correlations, SpearmanCorrcoef and KendallRankCorrCoef.

Exact mode (``approx=None``): ranks are global over the epoch, so the metrics
keep two list states (PaddedBuffers with ``capacity``), gathered across ranks
at ``compute()``. ``approx="sketch"``: a constant-memory ``num_bins x num_bins``
joint histogram (:class:`~metrics_tpu_torch.parallel.sketch.RankSketch`) over a
linear grid (``sketch_range=(lo, hi)``) or, by default, the range-free
soft-sign grid. ``approx="qsketch"``: the joint histogram on the log-bucketed
grid of relative accuracy ``alpha`` (``sketch_range`` must stay ``None``). A
sketch update is one scatter, the sync one ``all_reduce``, and equal-config
Spearman and Kendall members share one compute group.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.parallel.buffer import as_values
from metrics_tpu_torch.parallel.qsketch import (
    QSKETCH_RANK_ALPHA,
    QuantileSketch,
    qsketch_rank_group_key,
    qsketch_rank_spec,
    qsketch_rank_update,
)
from metrics_tpu_torch.parallel.sketch import (
    RankSketch,
    canonicalize_approx,
    rank_collision_bound,
    rank_sketch_group_key,
    rank_sketch_spec,
    sketch_rank_update,
)
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.prints import rank_zero_warn_once


class _RankCorrelation(Metric):
    """``preds_all`` / ``target_all`` float32 list states, or a ``joint``
    sketch; subclasses compute."""

    _score_kind = "scalar predictions"
    _EXACT_WARNING = ""

    def __init__(
        self,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        capacity: Optional[int] = None,
        approx: Optional[str] = None,
        num_bins: int = 512,
        sketch_range: Optional[Tuple[float, float]] = None,
        alpha: float = QSKETCH_RANK_ALPHA,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, dist_sync_fn=dist_sync_fn, device=device, capacity=capacity)
        self.approx = canonicalize_approx(approx, allowed=("sketch", "qsketch"))
        self.num_bins = num_bins
        self.sketch_range = None if sketch_range is None else tuple(sketch_range)
        self.alpha = float(alpha)
        if self.sketch_range is not None and len(self.sketch_range) != 2:
            raise ValueError(f"`sketch_range` must be None or a (lo, hi) pair, got {sketch_range!r}")
        if self.approx == "qsketch":
            if self.sketch_range is not None:
                raise ValueError(
                    "approx='qsketch' is range-free by construction (the log-bucketed"
                    " grid has no (lo, hi)); drop `sketch_range`, or use"
                    " approx='sketch' for the fixed linear grid"
                )
            self.add_state("joint", default=qsketch_rank_spec(self.alpha), dist_reduce_fx="sum")
            return
        if self.approx == "sketch":
            lo, hi = self.sketch_range if self.sketch_range is not None else (None, None)
            self.add_state("joint", default=rank_sketch_spec(num_bins, lo, hi), dist_reduce_fx="sum")
            return
        self.add_state("preds_all", default=[], dist_reduce_fx=None, item_shape=())
        self.add_state("target_all", default=[], dist_reduce_fx=None, item_shape=())
        rank_zero_warn_once(type(self)._EXACT_WARNING)

    def update(self, preds: Tensor, target: Tensor) -> None:
        _check_same_shape(preds, target)
        if preds.ndim != 1:
            raise ValueError(f"Expected both `preds` and `target` to be 1D arrays of {self._score_kind}")
        if self.approx == "qsketch":
            spec = self._defaults["joint"]
            self.joint = QuantileSketch(
                qsketch_rank_update(self.joint.counts, preds, target, spec.alpha, spec.min_value, spec.max_value))
            return
        if self.approx == "sketch":
            lo, hi = self.sketch_range if self.sketch_range is not None else (None, None)
            self.joint = RankSketch(sketch_rank_update(self.joint.counts, preds, target, lo, hi))
            return
        self._append("preds_all", preds.to(torch.float32))
        self._append("target_all", target.to(torch.float32))

    def _group_fingerprint(self) -> Optional[Any]:
        # sketch-mode Spearman and Kendall share one joint-histogram update:
        # equal sketch config means one compute-group delta
        if self.approx == "qsketch":
            return qsketch_rank_group_key(self)
        if self.approx == "sketch":
            return rank_sketch_group_key(self)
        return super()._group_fingerprint()

    def collision_bound(self) -> Tensor:
        """Certificate of the sketch modes: the fraction of pairs colliding in one
        grid bucket on either variable, the only pairs the binned statistic
        resolves as ties instead of exactly."""
        if self.approx is None:
            raise ValueError("collision_bound() needs approx='sketch' or 'qsketch'")
        return rank_collision_bound(self.joint.counts)

    def _states_own_sync(self) -> bool:
        from metrics_tpu_torch.parallel.sharded_dispatch import rank_corr_applicable

        return rank_corr_applicable(self) is not None

    def _epoch(self) -> Tuple[Tensor, Tensor]:
        return as_values(self.preds_all), as_values(self.target_all)
