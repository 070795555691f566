"""KendallRankCorrCoef module, exact or sketched. Counterpart of ``metrics_tpu/regression/kendall.py``."""
import torch
from torch import Tensor

from metrics_tpu_torch.functional.regression.kendall import _kendall_kernel, _warn_if_quadratic
from metrics_tpu_torch.parallel.sharded_dispatch import kendall_sharded
from metrics_tpu_torch.parallel.sketch import kendall_from_joint
from metrics_tpu_torch.regression._rank_corr import _RankCorrelation


class KendallRankCorrCoef(_RankCorrelation):
    r"""Accumulated Kendall rank correlation (tau-b, tie-corrected) over every
    pair seen. The epoch compute is O(N^2) in the accumulated length, walked in
    row blocks (``functional/regression/kendall.py``); keep an epoch below
    ~100k samples. ``approx="sketch"`` / ``"qsketch"`` keep a joint histogram
    instead: tau-b from its concordance sums, O(bins^2) at compute.

    Example:
        >>> import torch
        >>> preds = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> target = torch.tensor([1.0, 3.0, 2.0, 4.0])
        >>> kendall = KendallRankCorrCoef(device="cpu")
        >>> round(float(kendall(preds, target)), 4)
        0.6667
    """

    _score_kind = "scalar scores"
    _EXACT_WARNING = (
        "Metric `KendallRankCorrCoef` stores every prediction and target in"
        " an O(samples) buffer state and computes an O(N^2) pairwise"
        " contraction at epoch end. Construct with `approx=\"qsketch\"` for"
        " a constant-memory RANGE-FREE joint rank sketch on the log-bucketed"
        " relative-accuracy grid, or `approx=\"sketch\"` for the fixed-grid"
        " variant (both synced with one all_reduce, O(bins^2) compute); exact"
        " buffers remain the default."
    )

    def compute(self) -> Tensor:
        if self.approx is not None:
            return kendall_from_joint(self.joint.counts)
        sharded = kendall_sharded(self)  # row-sharded epoch states: the contraction split over the ring
        if sharded is not None:
            return sharded
        preds, target = self._epoch()
        if preds.shape[0] < 2:
            return torch.tensor(float("nan"), device=self.device)
        _warn_if_quadratic(preds.shape[0])
        return _kendall_kernel(preds, target)
