"""The exact mode of the rank correlations: every prediction and target kept.

Ranks are global over the epoch, so SpearmanCorrcoef and KendallRankCorrCoef
keep two list states (PaddedBuffers with ``capacity``), gathered across ranks
at ``compute()``. The sketch modes of the JAX package (``approx="sketch"`` /
``"qsketch"``) wait for the mergeable sketch states (ROADMAP section 1, item 4)
and raise ``NotImplementedError``.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.classification._curve_base import check_approx
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.parallel.buffer import as_values
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.prints import rank_zero_warn_once

# the default relative accuracy of the JAX package's qsketch rank grid
# (``metrics_tpu/parallel/qsketch.py``), kept for the signature
QSKETCH_RANK_ALPHA = 0.1


class _RankCorrelation(Metric):
    """``preds_all`` / ``target_all`` float32 list states; subclasses compute."""

    _score_kind = "scalar predictions"

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
        check_approx(approx, ("sketch", "qsketch"))
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, dist_sync_fn=dist_sync_fn, device=device, capacity=capacity)
        self.approx = approx
        self.num_bins = num_bins
        self.sketch_range = None if sketch_range is None else tuple(sketch_range)
        self.alpha = float(alpha)
        self.add_state("preds_all", default=[], dist_reduce_fx=None, item_shape=())
        self.add_state("target_all", default=[], dist_reduce_fx=None, item_shape=())
        rank_zero_warn_once(
            f"Metric `{type(self).__name__}` stores every prediction and target in an O(samples)"
            " buffer state (ranks are global over the epoch), so memory and sync traffic grow"
            " with the dataset."
        )

    def update(self, preds: Tensor, target: Tensor) -> None:
        _check_same_shape(preds, target)
        if preds.ndim != 1:
            raise ValueError(f"Expected both `preds` and `target` to be 1D arrays of {self._score_kind}")
        self._append("preds_all", preds.to(torch.float32))
        self._append("target_all", target.to(torch.float32))

    def _epoch(self) -> Tuple[Tensor, Tensor]:
        return as_values(self.preds_all), as_values(self.target_all)
