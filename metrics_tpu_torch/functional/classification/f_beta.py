"""F-beta / F1 functionals.

Counterpart of ``metrics_tpu/functional/classification/f_beta.py``.
"""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.stat_scores import _reduce_stat_scores
from metrics_tpu_torch.functional.classification.precision_recall import _prf_stats
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _safe_divide(num: Tensor, denom: Tensor) -> Tensor:
    """num / denom with 0-denominators treated as 1."""
    return num / torch.where(denom == 0, torch.ones_like(denom), denom)


def _fbeta_compute(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    beta: float,
    ignore_index: Optional[int],
    average: str,
    mdmc_average: Optional[str],
) -> Tensor:
    tp_f, fp_f, fn_f = tp.to(torch.float32), fp.to(torch.float32), fn.to(torch.float32)

    if average == "micro" and mdmc_average != MDMCAverageMethod.SAMPLEWISE:
        # ignored classes carry -1 sentinels; mask them out of the global sums
        mask = tp >= 0

        def msum(x: Tensor) -> Tensor:
            return torch.sum(torch.where(mask, x, torch.zeros_like(x)))

        precision = _safe_divide(msum(tp_f), msum(tp_f) + msum(fp_f))
        recall = _safe_divide(msum(tp_f), msum(tp_f) + msum(fn_f))
    else:
        precision = _safe_divide(tp_f, tp_f + fp_f)
        recall = _safe_divide(tp_f, tp_f + fn_f)

    num = (1 + beta**2) * precision * recall
    denom = beta**2 * precision + recall
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)

    if ignore_index is not None and average not in (AverageMethod.MICRO, AverageMethod.SAMPLES):
        num, denom = num.clone(), denom.clone()
        if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
            num[..., ignore_index] = -1
            denom[..., ignore_index] = -1
        else:
            num[ignore_index, ...] = -1
            denom[ignore_index, ...] = -1

    return _reduce_stat_scores(
        numerator=num,
        denominator=denom,
        weights=None if average != "weighted" else tp + fn,
        average=average,
        mdmc_average=mdmc_average,
    )


def fbeta(
    preds: Tensor,
    target: Tensor,
    beta: float = 1.0,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    is_multiclass: Optional[bool] = None,
) -> Tensor:
    r"""F-beta: ``(1 + beta^2) * P * R / (beta^2 * P + R)``.

    Example:
        >>> import torch
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> round(float(fbeta(preds, target, num_classes=3, beta=0.5)), 4)
        0.3333
    """
    tp, fp, tn, fn = _prf_stats(
        preds, target, average, mdmc_average, ignore_index, num_classes, threshold, top_k, is_multiclass
    )
    return _fbeta_compute(tp, fp, tn, fn, beta, ignore_index, average, mdmc_average)


def f1(
    preds: Tensor,
    target: Tensor,
    beta: float = 1.0,
    average: str = "micro",
    mdmc_average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    num_classes: Optional[int] = None,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    is_multiclass: Optional[bool] = None,
) -> Tensor:
    """F1 = harmonic mean of precision and recall (fbeta with beta=1).

    Example:
        >>> import torch
        >>> target = torch.tensor([0, 1, 2, 0, 1, 2])
        >>> preds = torch.tensor([0, 2, 1, 0, 0, 1])
        >>> round(float(f1(preds, target, num_classes=3)), 4)
        0.3333
    """
    return fbeta(preds, target, 1.0, average, mdmc_average, ignore_index, num_classes, threshold, top_k, is_multiclass)
