"""StatScores module.

Counterpart of ``metrics_tpu/classification/stat_scores.py``. The shared
score-reduction helper ``_reduce_stat_scores``, which the JAX package keeps
here, lives in ``functional/classification/stat_scores.py`` so that the
functional package does not import the module package; it is re-exported.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.stat_scores import (  # noqa: F401  (_reduce_stat_scores re-exported)
    _reduce_stat_scores,
    _stat_scores_compute,
    _stat_scores_update,
)
from metrics_tpu_torch.utils.data import dim_zero_cat


class StatScores(Metric):
    """Accumulate tp/fp/tn/fn (+support at compute) over batches.

    Scalar / ``(C,)`` int64 "sum" states for global reductions, cat states
    when per-sample scores are requested.

    Example:
        >>> import torch
        >>> preds = torch.tensor([1, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> stat_scores = StatScores(reduce='macro', num_classes=3, device="cpu")
        >>> stat_scores(preds, target)
        tensor([[0, 1, 2, 1, 1],
                [1, 1, 1, 1, 2],
                [1, 0, 3, 0, 1]])
    """

    # MetricCollection compute groups: every StatScores-family metric runs the
    # SAME update over tp/fp/tn/fn; only compute differs. These are the
    # update-relevant config attrs (compute-only config such as FBeta.beta or
    # the subclasses' ``average`` is deliberately absent).
    _GROUP_UPDATE_ATTRS = (
        "reduce", "mdmc_reduce", "num_classes", "threshold", "is_multiclass",
        "ignore_index", "top_k",
    )

    def __init__(
        self,
        threshold: float = 0.5,
        top_k: Optional[int] = None,
        reduce: str = "micro",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        mdmc_reduce: Optional[str] = None,
        is_multiclass: Optional[bool] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )

        self.reduce = reduce
        self.mdmc_reduce = mdmc_reduce
        self.num_classes = num_classes
        self.threshold = threshold
        self.is_multiclass = is_multiclass
        self.ignore_index = ignore_index
        self.top_k = top_k

        if not 0 < threshold < 1:
            raise ValueError(f"The `threshold` should be a float in the (0,1) interval, got {threshold}")
        if reduce not in ["micro", "macro", "samples"]:
            raise ValueError(f"The `reduce` {reduce} is not valid.")
        if mdmc_reduce not in [None, "samplewise", "global"]:
            raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
        if reduce == "macro" and (not num_classes or num_classes < 1):
            raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
        if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
            raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

        if mdmc_reduce != "samplewise" and reduce != "samples":
            zeros_shape = () if reduce == "micro" else (num_classes,)
            for s in ("tp", "fp", "tn", "fn"):
                self.add_state(s, default=torch.zeros(zeros_shape, dtype=torch.int64), dist_reduce_fx="sum")
        else:
            for s in ("tp", "fp", "tn", "fn"):
                self.add_state(s, default=[], dist_reduce_fx=None)

    def update(self, preds: Tensor, target: Tensor) -> None:
        tp, fp, tn, fn = _stat_scores_update(
            preds,
            target,
            reduce=self.reduce,
            mdmc_reduce=self.mdmc_reduce,
            threshold=self.threshold,
            num_classes=self.num_classes,
            top_k=self.top_k,
            is_multiclass=self.is_multiclass,
            ignore_index=self.ignore_index,
        )

        if self.reduce != "samples" and self.mdmc_reduce != "samplewise":
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.tn = self.tn + tn
            self.fn = self.fn + fn
        else:
            self._append("tp", tp)
            self._append("fp", fp)
            self._append("tn", tn)
            self._append("fn", fn)

    def _get_final_stats(self) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        if isinstance(self.tp, list):
            return (
                dim_zero_cat(self.tp),
                dim_zero_cat(self.fp),
                dim_zero_cat(self.tn),
                dim_zero_cat(self.fn),
            )
        return self.tp, self.fp, self.tn, self.fn

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _stat_scores_compute(tp, fp, tn, fn)

