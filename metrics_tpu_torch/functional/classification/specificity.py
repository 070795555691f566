"""Specificity functional.

Counterpart of ``metrics_tpu/functional/classification/specificity.py``:
TN / (TN + FP) on the stat-scores reduction that precision and recall use.
"""
from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.classification.precision_recall import _prf_stats
from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores


def _specificity_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: str, mdmc_average: Optional[str]
) -> Tensor:
    return _reduce_stat_scores(
        numerator=tn,
        denominator=tn + fp,
        weights=None if average != "weighted" else tn + fp,
        average=average,
        mdmc_average=mdmc_average,
    )


def specificity(
    preds: Tensor,
    target: Tensor,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    is_multiclass: Optional[bool] = None,
) -> Tensor:
    r"""Specificity = TN / (TN + FP), with micro/macro/weighted/none/samples averaging.

    Example:
        >>> import torch
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> round(float(specificity(preds, target, average='macro', num_classes=3)), 4)
        0.6111
        >>> float(specificity(preds, target, average='micro'))
        0.625
    """
    tp, fp, tn, fn = _prf_stats(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, is_multiclass
    )
    return _specificity_compute(tp, fp, tn, fn, average, mdmc_average)
