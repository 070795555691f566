"""Precision / Recall functionals.

Counterpart of ``metrics_tpu/functional/classification/precision_recall.py``.
"""
from typing import Optional, Tuple

from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores, _stat_scores_update

_ALLOWED_AVERAGE = ["micro", "macro", "weighted", "samples", "none", None]
_ALLOWED_MDMC = [None, "samplewise", "global"]


def _check_prf_args(average, mdmc_average, num_classes, ignore_index) -> None:
    if average not in _ALLOWED_AVERAGE:
        raise ValueError(f"The `average` has to be one of {_ALLOWED_AVERAGE}, got {average}.")
    if mdmc_average not in _ALLOWED_MDMC:
        raise ValueError(f"The `mdmc_average` has to be one of {_ALLOWED_MDMC}, got {mdmc_average}.")
    if average in ["macro", "weighted", "none", None] and (not num_classes or num_classes < 1):
        raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")


def _precision_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: str, mdmc_average: Optional[str]
) -> Tensor:
    return _reduce_stat_scores(
        numerator=tp,
        denominator=tp + fp,
        weights=None if average != "weighted" else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def _recall_compute(
    tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor, average: str, mdmc_average: Optional[str]
) -> Tensor:
    return _reduce_stat_scores(
        numerator=tp,
        denominator=tp + fn,
        weights=None if average != "weighted" else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def _prf_stats(preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, is_multiclass):
    _check_prf_args(average, mdmc_average, num_classes, ignore_index)
    reduce = "macro" if average in ["weighted", "none", None] else average
    return _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_average,
        threshold=threshold,
        num_classes=num_classes,
        top_k=top_k,
        is_multiclass=is_multiclass,
        ignore_index=ignore_index,
    )


def precision(
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
    r"""Precision = TP / (TP + FP), with micro/macro/weighted/none/samples averaging.

    Example:
        >>> import torch
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> round(float(precision(preds, target, average='macro', num_classes=3)), 4)
        0.1667
        >>> float(precision(preds, target, average='micro'))
        0.25
    """
    tp, fp, tn, fn = _prf_stats(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, is_multiclass
    )
    return _precision_compute(tp, fp, tn, fn, average, mdmc_average)


def recall(
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
    r"""Recall = TP / (TP + FN), with micro/macro/weighted/none/samples averaging.

    Example:
        >>> import torch
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> round(float(recall(preds, target, average='macro', num_classes=3)), 4)
        0.3333
        >>> float(recall(preds, target, average='micro'))
        0.25
    """
    tp, fp, tn, fn = _prf_stats(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, is_multiclass
    )
    return _recall_compute(tp, fp, tn, fn, average, mdmc_average)


def precision_recall(
    preds: Tensor,
    target: Tensor,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    is_multiclass: Optional[bool] = None,
) -> Tuple[Tensor, Tensor]:
    """Both precision and recall from a single stat-scores pass."""
    tp, fp, tn, fn = _prf_stats(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, is_multiclass
    )
    return (
        _precision_compute(tp, fp, tn, fn, average, mdmc_average),
        _recall_compute(tp, fp, tn, fn, average, mdmc_average),
    )
